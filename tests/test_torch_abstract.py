"""Port parity: the abstract model surface against the JAX package's.

For every arch (reduced), ``bundle.abstract()`` builds the model on
``meta`` and its per-block parameters, stacked back by
`optim.optimizers.leaves`, have the reference's leaves: names, shapes,
dtypes and logical specs (one leading ``"layers"`` per stacking level, as
`models.registry` states). The full Kimi K2 config (about 1T parameters)
comes back on ``meta`` without allocating. `input_specs` gives every cell
of `configs.base.cells` the reference's input shapes and dtypes (for
decode the cache's leaves and total bytes), and `batch_logical_specs` its
names.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.configs.base as RC  # noqa: E402
from repro.models import batch_logical_specs as rbatch_specs  # noqa: E402
from repro.models import build as rbuild  # noqa: E402
from repro.models import input_specs as rinput_specs  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import (batch_logical_specs, build,  # noqa: E402
                                input_specs)
from repro_torch.models.registry import param_spec  # noqa: E402
from repro_torch.optim.optimizers import leaves  # noqa: E402


def _is_spec(x):
    return x is None or (isinstance(x, tuple)
                         and all(e is None or isinstance(e, str) for e in x))


def _ref_leaves(tree, specs):
    """{dotted name: (shape, dtype name, spec)} of a reference tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_s = jax.tree.leaves(specs, is_leaf=_is_spec)
    assert len(flat) == len(flat_s)
    return {".".join(str(k.key) for k in path):
            (tuple(v.shape), jnp.dtype(v.dtype).name, s)
            for (path, v), s in zip(flat, flat_s)}


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_abstract_matches_the_references_leaves(arch):
    rshapes, rspecs = rbuild(RC.reduced(RC.get_config(arch))).abstract()
    want = _ref_leaves(rshapes, rspecs)
    model, specs = build(TC.reduced(TC.get_config(arch)),
                         device="cpu").abstract()
    named = dict(model.named_parameters())
    assert set(specs) == set(named)
    assert all(p.is_meta for p in named.values())
    got = {}
    for leaf in leaves(named):
        member = named[leaf.members[0]]
        spec = specs[leaf.members[0]]
        assert all(specs[m] == spec for m in leaf.members)
        assert len(spec) == member.dim()
        got[leaf.name] = (tuple(leaf.shape(named)),
                          str(member.dtype).split(".")[-1],
                          ("layers",) * len(leaf.grid) + spec)
    assert got == want


def test_param_spec_refuses_an_unknown_parameter():
    assert param_spec("groups.3.moe.moe.wi", 4) == \
        ("experts", "fsdp", None, "mlp")
    assert param_spec("layers.0.mlp.wi", 2) == ("fsdp", "mlp")
    with pytest.raises(KeyError, match="no logical spec"):
        param_spec("layers.0.attn.w_extra", 2)
    with pytest.raises(KeyError, match="no logical spec"):
        param_spec("layers.0.mlp.wi", 4)


def test_full_config_abstract_no_alloc():
    """abstract() on the FULL kimi-k2 1T config must not allocate."""
    model, specs = build(TC.get_config("kimi_k2_1t_a32b"),
                         device="cpu").abstract()
    params = list(model.parameters())
    assert all(p.is_meta for p in params)
    assert sum(p.numel() for p in params) > 0.9e12   # ~1T params
    assert len(specs) == len(params)


def _tree_bytes(tree):
    return sum(int(np.prod(x.shape)) * jnp.dtype(x.dtype).itemsize
               for x in jax.tree.leaves(tree))


def _flat_port(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_port(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch,shape", RC.cells())
def test_input_specs_and_names_match_the_reference(arch, shape):
    rcfg, cfg = RC.get_config(arch), TC.get_config(arch)
    want = rinput_specs(rcfg, RC.SHAPES[shape])
    got = input_specs(cfg, TC.SHAPES[shape])
    assert set(got) == set(want)
    for name, w in want.items():
        if name == "cache":
            continue
        g = got[name]
        assert g.is_meta and tuple(g.shape) == tuple(w.shape), name
        assert str(g.dtype).split(".")[-1] == jnp.dtype(w.dtype).name, name
    names = batch_logical_specs(cfg, TC.SHAPES[shape])
    if "cache" in want:
        ref_cache = _ref_leaves(want["cache"], rbatch_specs(
            rcfg, RC.SHAPES[shape])["cache"])
        port_cache = _flat_port(got["cache"])
        port_names = _flat_port(names["cache"])
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1],
                    port_names[k]) for k, v in port_cache.items()} == \
            ref_cache
        assert all(v.is_meta for v in port_cache.values())
        assert sum(v.numel() * v.element_size()
                   for v in port_cache.values()) == _tree_bytes(
            want["cache"])
        names = {k: v for k, v in names.items() if k != "cache"}
        ref_names = {k: v for k, v in rbatch_specs(
            rcfg, RC.SHAPES[shape]).items() if k != "cache"}
    else:
        ref_names = rbatch_specs(rcfg, RC.SHAPES[shape])
    assert names == ref_names


def test_abstract_model_takes_meta_inputs_under_a_count_only():
    """The meta model serves meta stand-ins under `launch.hlocost.count`;
    outside one its flash launch raises (it never runs a plain version),
    and host tensors beside it raise as on any other device."""
    from repro_torch.launch.hlocost import count

    cfg = TC.reduced(TC.get_config("qwen3_0p6b"))
    bundle = build(cfg, device="cpu")
    model, _ = bundle.abstract()
    batch = input_specs(cfg, TC.ShapeConfig("p", 8, 2, "prefill"))
    seen = {}

    def prefill(p, b):
        seen["out"] = bundle.prefill(p, b)

    count(prefill, model, batch)
    logits, cache = seen["out"]
    assert logits.is_meta and tuple(logits.shape) == (2, cfg.padded_vocab)
    assert cache["k"].is_meta
    with pytest.raises(ValueError, match="only under launch.hlocost.count"):
        bundle.prefill(model, batch)
    with pytest.raises(ValueError, match="different devices"):
        bundle.prefill(model, {"tokens": torch.zeros(2, 8,
                                                     dtype=torch.long)})
