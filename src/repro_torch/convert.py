"""Carry state from the JAX package into the port, as numpy arrays.

Every function takes the reference's objects by duck typing (this module
imports nothing of `repro`): anything with the same attributes works.
Words cross as the same bits, uint32 -> int32 (`core.bitplane.as_words`),
onto ``device``: the card (``"cuda"``) unless the caller asks for the
CPU; asking for the card where there is none raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.apps.bitmap_index import UserDatabase
from repro_torch.core.bitplane import as_words
from repro_torch.core.lowering import LoweredProgram
from repro_torch.models.transformer import Transformer
from repro_torch.ops.predicate import VerticalColumn
from repro_torch.service.catalog import Catalog


def _words(x, device: torch.device) -> torch.Tensor:
    return as_words(np.asarray(x, dtype=np.uint32), device)


def catalog_from_reference(ref, device="cuda") -> Catalog:
    """A port `Catalog` holding the same entries, groups and columns as a
    reference `repro.service.catalog.Catalog`, in registration order (so
    the modeled DRAM placement is the same too)."""
    cat = Catalog(device=resolve_device(device))
    for name in ref.names():
        entry = ref.get(name)
        cat.register(name, np.asarray(entry.words, dtype=np.uint32),
                     entry.n_bits, group=entry.group)
    cat.columns.update(ref.columns)
    return cat


def user_database_from_reference(db, device="cuda") -> UserDatabase:
    """A port `apps.bitmap_index.UserDatabase` with the same daily and
    attribute bitmaps as a reference one."""
    dev = resolve_device(device)
    return UserDatabase(_words(db.daily, dev), _words(db.male, dev),
                        int(db.m_users))


def vertical_column_from_reference(col, device="cuda") -> VerticalColumn:
    """A port `ops.predicate.VerticalColumn` with the same planes as a
    reference one."""
    return VerticalColumn(_words(col.planes, resolve_device(device)),
                          int(col.n_bits), int(col.n_values))


def corpus_catalog_from_reference(cat, device="cuda"):
    """A port `data.bitmap_filter.CorpusCatalog` with the same attribute
    bitmaps and integer columns as a reference one."""
    from repro_torch.data.bitmap_filter import CorpusCatalog

    dev = resolve_device(device)
    return CorpusCatalog(
        {name: _words(w, dev) for name, w in cat.attrs.items()},
        {name: vertical_column_from_reference(col, dev)
         for name, col in cat.columns.items()}, int(cat.n_docs))


def lowered_from_reference(lp) -> LoweredProgram:
    """A port `LoweredProgram` with the reference program's rows and
    opcode table."""
    return LoweredProgram(
        row_names=tuple(lp.row_names),
        table=np.asarray(lp.table, dtype=np.int32),
        reads=tuple(lp.reads), writes=tuple(lp.writes), comment=lp.comment)


def _copy_tree(module, tree, index=None) -> None:
    """Copy every leaf of a reference parameter dict into the like-named
    parameter of ``module`` (``tree[name][index]`` for stacked layers)."""
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            _copy_tree(getattr(module, name), leaf, index)
            continue
        x = np.array(leaf if index is None else leaf[index],
                     dtype=np.float32)
        dst = getattr(module, name)
        if tuple(dst.shape) != x.shape:
            raise ValueError(f"{name}: reference {x.shape} vs port "
                             f"{tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(torch.from_numpy(x))


def _stacked_blocks(cfg, params):
    """(reference subtree, index) of each layer in the port's order: the
    dense family's ``layers[i]``; the MoE family's ``lead[i]``, then per
    super-layer g its ``groups.dense[g, j]`` and ``groups.moe[g]``."""
    if cfg.family != "moe":
        return [(params["layers"], i) for i in range(cfg.n_layers)]
    out = [(params["lead"], i) for i in range(cfg.n_dense_layers)]
    n_groups = (cfg.n_layers - cfg.n_dense_layers) // cfg.moe_every
    for g in range(n_groups):
        out += [(params["groups"]["dense"], (g, j))
                for j in range(cfg.moe_every - 1)]
        out.append((params["groups"]["moe"], g))
    return out


def _copy_blocks(blocks, tree, n: int) -> None:
    """Copy the ``n`` blocks stacked on ``tree``'s leading axis into
    ``blocks`` in order."""
    if len(blocks) != n:
        raise ValueError(f"{n} reference blocks for {len(blocks)} layers")
    for i, block in enumerate(blocks):
        _copy_tree(block, tree, index=i)


def _copy_transformer(model, cfg, params) -> None:
    blocks = _stacked_blocks(cfg, params)
    layers = model.blocks()
    if len(blocks) != len(layers):
        raise ValueError(f"{len(blocks)} reference blocks for "
                         f"{len(layers)} layers")
    for block, (tree, index) in zip(layers, blocks):
        _copy_tree(block, tree, index=index)


def _copy_hybrid(model, cfg, params) -> None:
    """Mamba2's ``layers[i]``; Zamba2's ``groups[g, j]`` (doubly stacked)
    and the unstacked ``shared`` block."""
    if cfg.family == "hybrid":
        n_groups = cfg.n_layers // cfg.attn_every
        for g in range(n_groups):
            for j, block in enumerate(model.groups[g]):
                _copy_tree(block, params["groups"], index=(g, j))
        _copy_tree(model.shared, params["shared"])
    else:
        _copy_blocks(model.layers, params["layers"], cfg.n_layers)


def _copy_encdec(model, cfg, params) -> None:
    _copy_tree(model, {k: params[k] for k in ("frontend_proj", "enc_norm")})
    _copy_blocks(model.enc, params["enc"], cfg.n_enc_layers)
    _copy_blocks(model.dec, params["dec"], cfg.n_layers)


def _copy_vlm(model, cfg, params) -> None:
    """Per group g: ``groups.self[g, j]`` (doubly stacked) and
    ``groups.cross[g]``."""
    _copy_tree(model, {"frontend_proj": params["frontend_proj"]})
    groups = params["groups"]
    for g, group in enumerate(model.groups):
        for j, block in enumerate(group.self_blocks()):
            _copy_tree(block, groups["self"], index=(g, j))
        _copy_tree(group.cross, groups["cross"], index=g)


def model_params_from_reference(cfg, params, device="cuda"):
    """The port's model of ``cfg`` holding the reference's parameters
    (``repro.models.build(cfg).init(key)``: a pytree of arrays with the
    layers stacked on leading axes), cast to ``cfg.dtype`` (the MoE router
    and the SSM's ``a_log`` / ``d_skip`` / ``dt_bias`` stay float32) on
    ``device``: a `transformer.Transformer` (dense: ``layers``; MoE:
    ``lead`` and ``groups.<g>.dense.<j>`` / ``groups.<g>.moe``, the
    reference's tree), a `hybrid.Hybrid` (Mamba2: ``layers``; Zamba2: ``groups
    (n_groups, attn_every, ...)`` and ``shared``), an `encdec.EncDec`
    (``enc``, ``dec``) or a `vision.VLM` (``groups.self (n_groups,
    n_self, ...)``, ``groups.cross``), one module per block."""
    from repro_torch.models.encdec import EncDec
    from repro_torch.models.hybrid import Hybrid
    from repro_torch.models.vision import VLM

    dev = resolve_device(device)
    family = {"dense": (Transformer, _copy_transformer),
              "moe": (Transformer, _copy_transformer),
              "ssm": (Hybrid, _copy_hybrid),
              "hybrid": (Hybrid, _copy_hybrid),
              "encdec": (EncDec, _copy_encdec),
              "vlm": (VLM, _copy_vlm)}
    if cfg.family not in family:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    cls, copy = family[cfg.family]
    model = cls(cfg, dev)
    _copy_tree(model.embed, params["embed"])
    _copy_tree(model, {"final_norm": params["final_norm"]})
    copy(model, cfg, params)
    return model


def _state_tree(tree, adafactor: bool, prefix: str = ""):
    """(port leaf name, value) of a reference optimizer-state tree shaped
    like the parameters: ``layers/attn/wq`` -> ``layers.attn.wq``; under
    adafactor a leaf is its ``{"r", "c"}`` or ``{"v"}`` dict."""
    for k in sorted(tree):
        v, name = tree[k], f"{prefix}{k}"
        if isinstance(v, dict) and not (adafactor and set(v) <= {"r", "c",
                                                                 "v"}):
            yield from _state_tree(v, adafactor, name + ".")
        else:
            yield name, v


def opt_state_from_reference(name: str, state, model: Transformer) -> dict:
    """A port optimizer state (`repro_torch.optim`) holding a reference
    optimizer's state tree (``opt.init(params)`` or a later ``update``'s),
    for optimizer ``name`` ("sgd", "adamw", "adafactor" or "signum"), on
    ``model``'s device. The port keys its state by the reference's leaves
    (`optim.optimizers.leaves`), stacked layers included, so every array
    keeps its shape and dtype."""
    from repro_torch.optim.optimizers import leaves

    expected = {leaf.name for leaf in leaves(dict(model.named_parameters()))}
    dev = model.device

    def tensor(x):
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                dev, torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(dev)

    out = {}
    for key, tree in state.items():
        items = dict(_state_tree(tree, name == "adafactor"))
        if set(items) != expected:
            raise ValueError(f"{name} state {key!r}: leaves "
                             f"{sorted(set(items) ^ expected)} differ from "
                             f"the model's")
        out[key] = {k: ({kk: tensor(vv) for kk, vv in v.items()}
                        if isinstance(v, dict) else tensor(v))
                    for k, v in items.items()}
    return out
