"""Port parity: the mesh (`launch.mesh`, `dist.sharding` on a
`DeviceMesh`, the sharded flash wrapper), on the CPU.

* Placements: `tree_shardings` over every arch's reduced and full
  ``bundle.abstract()``, read back as spec tuples (`spec_of`), equal the
  reference's `resolve_spec` of the same leaf (its stacked leaf less the
  leading ``"layers"`` axes) on a 16 x 16 and a 2 x 16 x 16 mesh, under
  each of the four rule tables.
* `constrain` is the identity outside a mesh and a redistribution to
  the resolved placements under one; the mesh makers raise where the
  world does not fit.
* The sharded flash wrapper (`kernels.ops.flash_attention` on DTensors,
  its `local_map` branch) on a 4-rank gloo mesh of (data 2, model 2) and
  (data 1, model 4), with KV heads that the model axis divides and
  fewer KV heads than model ranks: the forward, dq, dk and dv against
  the reference's `flash_attention` (its Pallas kernels in interpret
  mode) and ``jax.grad``, float32, to 1e-4 of the largest magnitude.

The four ranks are spawned once for the file (`launch.mesh.run_ranks`);
each case is a test of its own over their results.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs.base as RC  # noqa: E402
import repro.dist.sharding as rsh  # noqa: E402
from repro.kernels import flashattn as RF  # noqa: E402
from repro.models import build as rbuild  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.dist import sharding as tsh  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.optim.optimizers import leaves  # noqa: E402

TABLES = ["DEFAULT_RULES", "SP_RULES", "DECODE_SP_RULES", "DP_RULES"]
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
#: flash cases: (data, model, KV): KV divides the model axis or not
FLASH = [(2, 2, 2), (2, 2, 1), (1, 4, 4), (1, 4, 2)]
B, S, H, HD, BLOCK = 4, 40, 8, 16, 16
TOL = 1e-4


class FakeMesh:
    """The reference's mesh interface for `resolve_spec`: axis names and
    a devices array of the mesh's shape."""

    def __init__(self, axes):
        self.axis_names = tuple(axes)
        self.devices = np.empty(tuple(axes.values()), object)


def _ref_specs(arch, full):
    cfg = RC.get_config(arch)
    shapes, specs = rbuild(cfg if full else RC.reduced(cfg)).abstract()
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    flat_s = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, tuple))
    return {".".join(str(k.key) for k in path): (tuple(v.shape), s)
            for (path, v), s in zip(flat, flat_s)}


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_tree_shardings_match_resolve_spec(arch, full):
    ref = _ref_specs(arch, full)
    cfg = TC.get_config(arch)
    model, specs = build(cfg if full else TC.reduced(cfg),
                         device="cpu").abstract()
    named = dict(model.named_parameters())
    for mesh_name, mesh in MESHES.items():
        fake = FakeMesh(mesh)
        for table in TABLES:
            got = tsh.tree_shardings(model, specs, mesh,
                                     getattr(tsh, table))
            rules = getattr(rsh, table)
            for leaf in leaves(named):
                shape, names = ref[leaf.name]
                g = len(leaf.grid)
                want = tuple(rsh.resolve_spec(shape, names, fake, rules))
                assert all(w is None for w in want[:g]), leaf.name
                for m in leaf.members:
                    have = tsh.spec_of(got[m], mesh, named[m].dim())
                    assert have == want[g:], (mesh_name, table, m)


def test_placements_round_trip():
    mesh = MESHES["2x16x16"]
    spec = (("pod", "data"), None, "model")
    pl = tsh.placements_of(spec, mesh)
    assert [type(p).__name__ for p in pl] == ["Shard", "Shard", "Shard"]
    assert [p.dim for p in pl] == [0, 0, 2]
    assert tsh.spec_of(pl, mesh, 3) == spec
    assert tsh.spec_of(tsh.placements_of((None,), mesh), mesh, 1) == (None,)


def test_constrain_outside_a_mesh_and_on_axis_sizes():
    x = torch.ones(4, 4)
    assert tsh.constrain(x, "batch", None) is x
    with tsh.axis_rules({"data": 2}):
        with pytest.raises(ValueError, match="DeviceMesh"):
            tsh.constrain(x, "batch", None)
    assert tsh.match_vma(x, x) is x


def test_attention_contexts_record_and_validate():
    """The reference's attention knobs keep their names and defaults; both
    backends reach the flash kernels, so the contexts record the name,
    and an unknown backend raises. `moe_constraints` is the identity
    without a mesh, as the reference's `constrain` is."""
    import repro.models.layers as RL
    from repro_torch.models import layers as TL
    from repro_torch.models import moe as TM
    assert (RL._ATTN_BACKEND["name"], RL._ATTN_REMAT["on"]) == \
        ("chunked", False)
    assert TL.current_attention() == {"remat": False, "backend": "chunked"}
    with TL.attention_remat(True), TL.attention_backend("flash"):
        assert TL.current_attention() == {"remat": True, "backend": "flash"}
    assert TL.current_attention() == {"remat": False, "backend": "chunked"}
    with pytest.raises(ValueError, match="unknown attention backend"):
        with TL.attention_backend("pallas"):
            pass
    x = torch.ones(2, 3)
    with TM.moe_constraints():
        assert TM._c(x, "experts", None) is x


def test_mesh_makers_need_a_world():
    if torch.distributed.is_initialized():
        pytest.skip("a process group is up in this process")
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_host_mesh(model=2, device="cpu")
    with pytest.raises(RuntimeError, match="torchrun"):
        tmesh.init_from_env()


# --------------------------------------------------------------------------
# four gloo ranks
# --------------------------------------------------------------------------

def _draw(KV, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, HD), dtype=np.float32)
    k = rng.standard_normal((B, S, KV, HD), dtype=np.float32)
    v = rng.standard_normal((B, S, KV, HD), dtype=np.float32)
    do = rng.standard_normal((B, S, H, HD), dtype=np.float32)
    return q, k, v, do


def _ranks(rank, world):
    """Each rank's share of the file's cases; returns numpy results."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.dist import sharding as sh
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import (axis_group, make_host_mesh,
                                         make_production_mesh)

    torch.set_num_threads(1)
    out = {"flash": {}}
    for data, model, KV in FLASH:
        mesh = make_host_mesh(data, model, device="cpu")
        q, k, v, do = (torch.from_numpy(x) for x in _draw(KV, data * KV))
        rep = [Replicate()] * 2
        with sh.axis_rules(mesh):
            qd, kd, vd = (sh.distribute(x, mesh, rep).requires_grad_(True)
                          for x in (q, k, v))
            o = ops.flash_attention(sh.constrain(qd, "batch", None, "heads",
                                                 None), kd, vd, True, BLOCK,
                                    BLOCK)
            placements = tuple(o.placements)
            o.backward(sh.distribute(do, mesh, rep))
        out["flash"][(data, model, KV)] = (
            [x.full_tensor().detach().numpy() for x in (o, qd.grad, kd.grad,
                                                         vd.grad)],
            placements)
    # constrain: a redistribution to the resolved placements
    mesh = make_host_mesh(2, 2, device="cpu")
    x = sh.distribute(torch.arange(32.).reshape(4, 8), mesh,
                      [Replicate()] * 2)
    with sh.axis_rules(mesh):
        y = sh.constrain(x, "batch", "mlp")
        same = sh.constrain(y, "batch", "mlp") is y
        plain = sh.constrain(torch.ones(4, 8), "batch", None)
    out["constrain"] = (tuple(map(str, y.placements)),
                        tuple(y.to_local().shape), same,
                        isinstance(plain, DTensor),
                        tuple(map(str, plain.placements)),
                        y.full_tensor().numpy())
    out["axis_group"] = torch.distributed.get_world_size(
        axis_group(mesh, ("data",)))
    try:
        make_production_mesh(device="cpu")
        out["production"] = "built"
    except ValueError as e:
        out["production"] = str(e)
    try:
        make_host_mesh(model=3, device="cpu")
        out["model3"] = "built"
    except ValueError as e:
        out["model3"] = str(e)
    return out


@pytest.fixture(scope="module")
def ranks():
    return tmesh.run_ranks(_ranks, 4, timeout=300)


def _ref_flash(KV, seed):
    q, k, v, do = (jnp.asarray(x) for x in _draw(KV, seed))

    def f(q, k, v):
        return RF.flash_attention(q, k, v, True, BLOCK, BLOCK)

    o, vjp = jax.vjp(f, q, k, v)
    return [np.asarray(x) for x in (o, *vjp(do))]


@pytest.mark.parametrize("data,model,KV", FLASH)
def test_sharded_flash_matches_the_reference(ranks, data, model, KV):
    want = _ref_flash(KV, data * KV)
    for rank in ranks:
        got, placements = rank["flash"][(data, model, KV)]
        # batch on the data axis, heads on the model axis
        assert [str(p) for p in placements] == ["S(0)", "S(2)"]
        for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
            assert g.shape == w.shape, name
            err = np.abs(g - w).max() / np.abs(w).max()
            assert err < TOL, (name, err)


def test_constrain_redistributes_under_a_mesh(ranks):
    for rank in ranks:
        placements, local, same, wrapped, plain_pl, whole = rank["constrain"]
        assert placements == ("S(0)", "S(1)")
        assert local == (2, 4)
        assert same and wrapped
        assert plain_pl == ("S(0)", "R")
        np.testing.assert_array_equal(whole,
                                      np.arange(32.).reshape(4, 8))


def test_meshes_over_the_world(ranks):
    for rank in ranks:
        assert rank["axis_group"] == 2
        assert "256 ranks; the world has 4" in rank["production"]
        assert "does not divide the world of 4" in rank["model3"]
