"""Port parity: optimizers, schedules, clipping, the statistics over the
reference's stacked layers, optimizer state carried across, and the
compressed (majority-vote) step, on the CPU.

The quadratic is the JAX package's own (`tests/test_optim_train.py`):
both packages run the same optimizer for 60 steps from the same start,
and the port's final parameters must equal the reference's to 1e-5 (both
in float32, elementwise the same operations) and bring the loss below
0.5. The stacked-leaf tests give every layer's gradients another scale,
so a statistic taken per layer instead of over the stacked leaf moves the
update well past the tolerance (each test shows that too): held to the
reference's update of the stacked tree to 1e-4 of its largest magnitude.
The compressed step runs on a one-rank gloo group against the JAX
package's `make_train_step_compressed` on a one-device mesh.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs.base as RC  # noqa: E402
import repro.optim as ropt  # noqa: E402
from repro.data import SyntheticLM as RSyntheticLM  # noqa: E402
from repro.models import build as rbuild  # noqa: E402
from repro.train import make_train_step_compressed as rcompressed  # noqa
from repro_torch import configs as TC  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.convert import (model_params_from_reference,  # noqa: E402
                                 opt_state_from_reference)
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.optim.optimizers import leaves, named  # noqa: E402
from repro_torch.train import make_train_step_compressed  # noqa: E402


def _quadratic(opt, lib, steps=60):
    """(final params, final loss) of ``opt`` on sum(w^2) + b^2."""
    if lib == "jax":
        params = {"w": jnp.array([3.0, -2.0, 1.5]), "b": jnp.array(1.0)}
        st = opt.init(params)

        def loss_fn(p):
            return jnp.sum(p["w"] ** 2) + p["b"] ** 2

        @jax.jit
        def step(p, s, i):
            return opt.update(jax.grad(loss_fn)(p), s, p, i)

        for i in range(steps):
            params, st = step(params, st, jnp.int32(i))
        return ({k: np.asarray(v) for k, v in params.items()},
                float(loss_fn(params)))
    params = {"w": torch.tensor([3.0, -2.0, 1.5], requires_grad=True),
              "b": torch.tensor(1.0, requires_grad=True)}
    st = opt.init(params)
    for i in range(steps):
        loss = (params["w"] ** 2).sum() + params["b"] ** 2
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        params, st = opt.update(grads, st, params, i)
    w, b = (params[k].detach() for k in ("w", "b"))
    return {"w": w.numpy(), "b": b.numpy()}, float((w ** 2).sum() + b ** 2)


QUADRATIC = {
    "adamw": (lambda m: m.adamw(lambda s: 0.1, weight_decay=0.0)),
    "adafactor": (lambda m: m.adafactor(lambda s: 0.3)),
    "sgd": (lambda m: m.sgd(lambda s: 0.05, weight_decay=0.0)),
    # sign steps need a decaying schedule to settle
    "signum": (lambda m: m.signum(lambda s: 0.2 * 0.92 ** s,
                                  weight_decay=0.0)),
}


@pytest.mark.parametrize("name", list(QUADRATIC))
def test_optimizer_converges_quadratic_as_the_reference(name):
    want, want_loss = _quadratic(QUADRATIC[name](ropt), "jax")
    got, loss = _quadratic(QUADRATIC[name](topt), "torch")
    assert loss < 0.5, (name, loss)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=f"{name} {k}")
    assert abs(loss - want_loss) < 1e-5


def test_warmup_cosine_matches_reference():
    for args in ((1.0, 10, 100), (3e-3, 5, 40, 0.2), (0.5, 0, 10)):
        f, g = topt.warmup_cosine(*args), ropt.warmup_cosine(*args)
        for step in range(0, args[2] + 5):
            assert f(step) == pytest.approx(float(g(step)), rel=1e-6,
                                            abs=1e-12), (args, step)
    f = topt.warmup_cosine(1.0, 10, 100)
    assert f(0) == 0.0 and abs(f(10) - 1.0) < 1e-6 and f(50) < 1.0
    assert f(100) <= 0.1 + 1e-6
    assert topt.constant(0.1)(7) == float(np.float32(0.1))


def test_clip_by_global_norm():
    g = {"a": torch.ones(4) * 10.0, "b": torch.zeros(3, dtype=torch.bfloat16)}
    clipped, gn = topt.clip_by_global_norm(g, 1.0)
    assert abs(float(gn) - 20.0) < 1e-4
    assert abs(float(clipped["a"].norm()) - 1.0) < 1e-4
    assert clipped["b"].dtype == torch.bfloat16
    same, gn = topt.clip_by_global_norm({"a": torch.ones(4)}, 5.0)
    assert float(gn) == 2.0 and torch.equal(same["a"], torch.ones(4))


# ---------------------------------------------------------------------------
# large parameters taken in slices along their leading axis
# ---------------------------------------------------------------------------


def _slicing_case(seed=0):
    """Parameters and gradients of every shape the slicing meets: an
    expert weight (E, D, 2, F), a stacked one, a matrix, a 3-D weight, a
    vector, a stacked vector; float32, and one bf16 gradient."""
    rng = np.random.default_rng(seed)
    shapes = {"moe.wi": (6, 8, 2, 16), "layers.0.wo": (5, 4, 10),
              "layers.1.wo": (5, 4, 10), "embed.tok": (40, 24),
              "head": (12, 4, 10), "final_norm": (30,),
              "layers.0.ln": (24,), "layers.1.ln": (24,)}
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for k, s in shapes.items()}
    grads = {k: torch.from_numpy(
        (rng.standard_normal(s) * rng.uniform(0.1, 3.0)).astype(np.float32))
        for k, s in shapes.items()}
    grads["head"] = grads["head"].to(torch.bfloat16)
    return params, grads


@pytest.mark.parametrize("name", ["clip", "adamw", "adafactor"])
def test_sliced_updates_equal_the_whole(name, monkeypatch):
    """With `CHUNK_ELEMS` forced below every parameter (100 elements: an
    expert's row of 256 is one slice of its own), the clip and the
    optimizers give what they give on whole parameters: AdamW and the
    clip's scaled gradients element for element, the norm and
    Adafactor's statistics and update to float32 rounding (their sums
    run in another order); the clip scales the gradients in place and
    returns the same tree."""
    from repro_torch.optim import optimizers as O

    out = {}
    for chunk in (1 << 26, 100):
        monkeypatch.setattr(O, "CHUNK_ELEMS", chunk)
        params, grads = _slicing_case()
        if name == "clip":
            ids = {k: id(g) for k, g in grads.items()}
            clipped, gn = O.clip_by_global_norm(grads, 1.0)
            assert clipped is grads
            assert {k: id(g) for k, g in clipped.items()} == ids
            out[chunk] = ({k: g.float() for k, g in clipped.items()},
                          {"norm": gn})
            continue
        opt = O.get_optimizer(name, topt.constant(1e-2))
        state = opt.init(params)
        for step in range(2):
            opt.update(grads, state, params, step)
        flat = {}
        for key, entries in state.items():
            for leaf, v in entries.items():
                for k, x in (v.items() if isinstance(v, dict)
                             else [("", v)]):
                    flat[f"{key}.{leaf}.{k}"] = x
        out[chunk] = (params, flat)
    whole, sliced = out[1 << 26], out[100]
    for tree_w, tree_s in zip(whole, sliced):
        for k in tree_w:
            w, g = tree_w[k].float(), tree_s[k].float()
            if name == "adamw" or (name == "clip" and k != "norm"):
                assert torch.equal(g, w), k
            else:
                assert torch.allclose(g, w, rtol=1e-5, atol=1e-6), k


# ---------------------------------------------------------------------------
# statistics over the reference's stacked leaves
# ---------------------------------------------------------------------------


def _model(n_layers=3):
    rcfg = dataclasses.replace(RC.reduced(RC.get_config("qwen3_0p6b")),
                               dtype="float32", n_layers=n_layers)
    cfg = dataclasses.replace(TC.reduced(TC.get_config("qwen3_0p6b")),
                              dtype="float32", n_layers=n_layers)
    rp = rbuild(rcfg).init(jax.random.PRNGKey(0))
    return cfg, rp


def _layer_scaled_grads(rp, seed=0):
    """Random gradients shaped like the reference's tree, layer i of every
    stacked leaf scaled by 10**i."""
    rng = np.random.default_rng(seed)

    def one(path, x):
        g = rng.standard_normal(x.shape).astype(np.float32)
        if path[0].key == "layers":
            g *= (10.0 ** np.arange(x.shape[0]))[(...,) + (None,) *
                                                 (x.ndim - 1)]
        return g
    return jax.tree_util.tree_map_with_path(one, rp)


def _torch_grads(model, rgrads):
    """The reference's stacked gradients split into the port's per-layer
    parameter names."""
    flat = {".".join(str(k.key) for k in p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(rgrads)[0]}
    out = {}
    for leaf in leaves(named(model)):
        g = torch.from_numpy(flat[leaf.name])
        parts = g.unbind(0) if leaf.stacked else (g,)
        out.update(zip(leaf.members, parts))
    return out


def _held(model, rp_new):
    """The port's updated parameters against the reference's; returns the
    largest error as a share of each leaf's largest magnitude."""
    flat = {".".join(str(k.key) for k in p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(rp_new)[0]}
    tensors = named(model)
    worst = 0.0
    for leaf in leaves(tensors):
        got = leaf.gather(tensors).detach().numpy()
        want = flat[leaf.name]
        worst = max(worst, float(np.abs(got - want).max()
                                 / np.abs(want).max()))
    return worst


def _per_layer_update(opt, model, grads):
    """The same update with every layer's parameter a leaf of its own
    (what a port without the stacking would compute): the names lose the
    ``.<layer>.`` that `optim.optimizers.leaves` groups by."""
    tensors = {k.replace(".", "/"): v.detach().clone()
               for k, v in named(model).items()}
    opt.update({k.replace(".", "/"): g for k, g in grads.items()},
               opt.init(tensors), tensors, 0)
    return {k.replace("/", "."): v for k, v in tensors.items()}


@pytest.mark.parametrize("name", ["signum", "adafactor"])
def test_statistics_span_the_stacked_layers(name):
    """signum's scale ``mean |u|`` and adafactor's update-RMS clip are
    taken over each stacked leaf, all layers at once."""
    cfg, rp = _model()
    rgrads = _layer_scaled_grads(rp)
    make = {"signum": lambda m: m.signum(m.constant(1e-2)),
            "adafactor": lambda m: m.adafactor(m.constant(1e-2))}[name]
    ro = make(ropt)
    rp_new, _ = jax.jit(ro.update)(rgrads, ro.init(rp), rp, jnp.int32(0))
    model = model_params_from_reference(cfg, rp, device="cpu")
    opt = make(topt)
    grads = _torch_grads(model, rgrads)
    opt.update(grads, opt.init(model), model, 0)
    assert _held(model, rp_new) < 1e-4
    # per-layer statistics would differ well past the tolerance
    fresh = model_params_from_reference(cfg, rp, device="cpu")
    per_layer = _per_layer_update(opt, fresh, grads)
    for k, v in per_layer.items():
        fresh.get_parameter(k).data.copy_(v)
    assert _held(fresh, rp_new) > 1e-2


def test_adafactor_factors_the_stacked_norm_scales():
    """The stacked (L, D) norm scales are factored (row statistics over
    the layers, column statistics over D), as in the reference; a
    per-layer (D,) scale would keep a full second moment."""
    cfg, rp = _model()
    model = model_params_from_reference(cfg, rp, device="cpu")
    opt = topt.adafactor(topt.constant(1e-2))
    state = opt.init(model)["f"]
    L, D = cfg.n_layers, cfg.d_model
    assert state["layers.ln1"]["r"].shape == (L,)
    assert state["layers.ln1"]["c"].shape == (D,)
    assert set(state["final_norm"]) == {"v"}
    ro = ropt.adafactor(ropt.constant(1e-2))
    rstate = ro.init(rp)["f"]
    for leaf, st in state.items():
        ref = rstate
        for k in leaf.split("."):
            ref = ref[k]
        assert {k: tuple(v.shape) for k, v in st.items()} == \
            {k: tuple(v.shape) for k, v in ref.items()}, leaf
    rgrads = _layer_scaled_grads(rp, seed=1)
    rp_new, _ = jax.jit(ro.update)(rgrads, ro.init(rp), rp, jnp.int32(0))
    opt.update(_torch_grads(model, rgrads), opt.init(model), model, 0)
    assert _held(model, rp_new) < 1e-4


@pytest.mark.parametrize("name", ["sgd", "adamw", "adafactor", "signum"])
def test_opt_state_from_reference_has_the_port_layout(name):
    cfg, rp = _model(n_layers=2)
    model = model_params_from_reference(cfg, rp, device="cpu")
    rstate = getattr(ropt, name)(ropt.constant(1e-3)).init(rp)
    got = opt_state_from_reference(name, rstate, model)
    want = topt.get_optimizer(name, topt.constant(1e-3)).init(model)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].keys() == want[key].keys()
        for leaf, v in want[key].items():
            g = got[key][leaf]
            if isinstance(v, dict):
                assert {k: (x.shape, x.dtype) for k, x in g.items()} == \
                    {k: (x.shape, x.dtype) for k, x in v.items()}, leaf
            else:
                assert (g.shape, g.dtype) == (v.shape, v.dtype), leaf
    with pytest.raises(ValueError, match="differ from the model"):
        opt_state_from_reference(name, {"mu": {"w": np.zeros(3)}}, model)


# ---------------------------------------------------------------------------
# the compressed step on a one-rank group
# ---------------------------------------------------------------------------


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("accum", [1, 2])
def test_compressed_step_matches_reference(world_of_one, accum):
    """The majority-vote signum step (packed signs through the all-to-all,
    the majority kernel and the all-gather) against the reference's on a
    one-device mesh: loss, grad norm and parameters; the elements whose
    ``u`` is within 1e-3 of its leaf's largest may take the other sign,
    as in `_torch_train_parity`."""
    cfg, _ = _model(n_layers=2)
    rcfg = dataclasses.replace(RC.reduced(RC.get_config("qwen3_0p6b")),
                               dtype="float32", n_layers=2)
    rb = rbuild(rcfg)
    rp = rb.init(jax.random.PRNGKey(0))
    batch = RSyntheticLM(rcfg.vocab_size, 16, 4, seed=3).batch(0)
    mesh = jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    ro = ropt.signum(ropt.constant(1e-3), axis_name="data")
    rstep = rcompressed(rb, ro, mesh, dp_axes=("data",), grad_accum=accum)
    rp1, _, rm = rstep(rp, ro.init(rp), jnp.int32(0), batch)

    bundle = build(cfg, device="cpu")
    model = model_params_from_reference(cfg, rp, device="cpu")
    opt = topt.signum(topt.constant(1e-3), group=world_of_one)
    step = make_train_step_compressed(bundle, opt, world_of_one,
                                      grad_accum=accum)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    model, state, m = step(model, opt.init(model), 0, tbatch)
    for k in ("loss", "grad_norm"):
        assert abs(float(m[k]) - float(rm[k])) < 1e-4 * abs(float(rm[k]))
    grad = jax.grad(lambda p, b: rb.loss(p, b)[0])(rp, batch)
    flat_g = {".".join(str(k.key) for k in p): np.asarray(v) for p, v in
              jax.tree_util.tree_flatten_with_path(grad)[0]}
    flat_p = {".".join(str(k.key) for k in p): np.asarray(v) for p, v in
              jax.tree_util.tree_flatten_with_path(rp1)[0]}
    tensors = named(model)
    for leaf in leaves(tensors):
        got = leaf.gather(tensors).detach().numpy()
        want = flat_p[leaf.name]
        err = np.abs(got - want) / np.abs(want).max()
        g = np.abs(flat_g[leaf.name])
        off = (err >= 1e-4) & ~(g < 1e-3 * g.max())
        assert not off.any(), leaf.name


def test_train_cli_runs_on_the_cpu(capsys):
    assert ttrain.main(["--device", "cpu", "--steps", "2", "--seq", "16",
                        "--batch", "4", "--log-every", "1",
                        "--grad-accum", "2"]) == 0
    out = capsys.readouterr().out
    assert "device=cpu" in out and "step     1 loss" in out
    # a mesh spans a world of ranks: none here (no torchrun environment)
    with pytest.raises(RuntimeError, match="torchrun"):
        ttrain.main(["--device", "cpu", "--model-parallel", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain.main(["--steps", "1"])


@pytest.mark.parametrize("arch", ["llama4_maverick_400b_a17b",
                                  "kimi_k2_1t_a32b"])
def test_train_cli_checkpoints_and_resumes_an_moe_arch(arch, tmp_path,
                                                       capsys):
    """``--ckpt-dir``: the reference's resilient loop trains a reduced MoE
    arch 3 steps (checkpoints at 2 and 3), a second run resumes at step 3
    and runs to 5; the reference's ``Checkpointer`` restores the port's
    files into its own ``(params, adamw state)``, every leaf under the
    reference's path and equal to the port's."""
    from repro.checkpoint.checkpointer import Checkpointer as RCheckpointer
    from repro.checkpoint.checkpointer import _flatten_with_paths as rpaths
    from repro_torch.checkpoint.checkpointer import \
        _flatten_with_paths as tpaths
    from repro_torch.train.state import TrainCheckpointer, reference_tree

    ck = str(tmp_path / "ck")
    args = ["--device", "cpu", "--arch", arch, "--batch", "2", "--seq",
            "16", "--ckpt-dir", ck, "--ckpt-every", "2", "--log-every", "1"]
    assert ttrain.main(args + ["--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "ran 3 steps" in out and "timeline ckpt@2 ckpt@3" in out
    assert ttrain.main(args + ["--steps", "5"]) == 0
    out = capsys.readouterr().out
    assert "ran 2 steps" in out and "timeline resume@3 ckpt@4 ckpt@5" in out
    assert "step     3 loss" in out and "step     2 loss" not in out

    # the reference's own (params, adamw state) tree, by shape only
    rcfg = RC.reduced(RC.get_config(arch))
    rp = jax.eval_shape(rbuild(rcfg).init, jax.random.PRNGKey(1))
    rs = jax.eval_shape(ropt.adamw(ropt.constant(1e-3)).init, rp)
    step, (rp5, rs5), _ = RCheckpointer(ck).restore((rp, rs))
    assert step == 5
    for (_, w), (_, like) in zip(rpaths((rp5, rs5)), rpaths((rp, rs))):
        assert w.shape == like.shape and w.dtype == like.dtype
    # the port's own restore of the same files, into a fresh model
    cfg = TC.reduced(TC.get_config(arch))
    model = build(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    opt = topt.get_optimizer("adamw", topt.constant(1e-3))
    state = opt.init(model)
    assert TrainCheckpointer(ck).restore((model, state))[0] == 5
    ours = reference_tree(model, state)
    want = rpaths((rp5, rs5))
    got = tpaths(ours)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] \
            == str(w.dtype), name
        np.testing.assert_array_equal(g.float().numpy(),
                                      w.astype(np.float32), err_msg=name)
