"""Port parity: training across ranks on the CPU: ``launch/train.py
--model-parallel`` and the compressed signum step on 4 gloo ranks.

* The training CLI with ``--model-parallel 2 --device cpu`` on 4 ranks
  (a (data 2, model 2) mesh), started ``--init-from`` a checkpoint of the
  reference's reduced Qwen3 (its ``init(PRNGKey(0))`` and AdamW state,
  written by the reference's ``Checkpointer``): its losses over three
  steps against the reference's jitted step with the CLI's optimizer and
  schedule on the same batches (the port's `SyntheticLM`, which the CLI
  draws), in bf16 to 1% of the loss.
* The compressed step (`launch.cells.build_cell` with ``compressed_dp``)
  of reduced Qwen3 (2 layers, float32) on a (data 4, model 1) mesh
  against the reference's `make_train_step_compressed` on a 4-device
  host mesh, run in a subprocess (as `tests/test_sharding_launch.py`
  runs its own): each rank's packed signs against the reference device's
  bit for bit wherever their ``u`` agree in sign (elements whose ``u``
  lies within 1e-3 of the leaf's largest may take the other sign, as in
  `_torch_train_parity`), the voted words against the majority of the
  packed signs computed in numpy (both packages), and so against each
  other wherever the inputs agree; loss, grad norm and parameters to the
  tolerance of `tests/test_torch_optim_train.py`. On a (data 2, model
  2) mesh, where each rank packs its model shards, the step against the
  reference's on a (2, 2) mesh.

The ranks are spawned once for the file and the reference's subprocess
runs meanwhile.
"""
import concurrent.futures
import dataclasses
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import _torch_mesh_ranks as R  # noqa: E402
import repro.configs.base as RC  # noqa: E402
import repro.optim as ropt  # noqa: E402
from repro.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro.data import SyntheticLM as RSyntheticLM  # noqa: E402
from repro.models import build as rbuild  # noqa: E402
from repro.train import make_train_step as rmake_train_step  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import model_params_from_reference  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.optim.optimizers import leaves  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, SEQ, BATCH, CLI_LR = 3, 16, 4, 3e-3
N_LAYERS = 2
SIGN_FRAC = 1e-3

_REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, {repo!r} + "/src")
    import dataclasses, importlib
    import jax, jax.numpy as jnp, numpy as np
    import repro.configs.base as RC
    import repro.optim as ropt
    RS = importlib.import_module("repro.optim.signum")
    from repro.data import SyntheticLM
    from repro.models import build
    from repro.train import make_train_step_compressed
    cfg = dataclasses.replace(RC.reduced(RC.get_config("qwen3_0p6b")),
                              dtype="float32", n_layers={n_layers})
    rb = build(cfg)
    rp = rb.init(jax.random.PRNGKey(0))
    batch = SyntheticLM(cfg.vocab_size, {seq}, {batch}, seed=3).batch(0)
    seen = {{}}
    vote = RS.majority_allreduce

    def recorded(packed, axis_name, use_kernel=True):
        out = vote(packed, axis_name, use_kernel)
        i = jax.lax.axis_index(axis_name)
        jax.debug.callback(lambda i, p, o: seen.setdefault(
            int(i), (np.asarray(p), np.asarray(o))), i, packed, out)
        return out

    RS.majority_allreduce = recorded
    out = {{}}
    for tag, shape in (("41", (4,)), ("22", (2, 2))):
        axes = ("data",) if len(shape) == 1 else ("data", "model")
        mesh = jax.make_mesh(shape, axes, axis_types=(
            jax.sharding.AxisType.Auto,) * len(shape))
        opt = ropt.signum(ropt.constant({lr}), axis_name="data",
                          use_kernel=False)
        step = make_train_step_compressed(rb, opt, mesh, dp_axes=("data",))
        seen.clear()
        p1, _, m = step(rp, opt.init(rp), jnp.int32(0), batch)
        jax.effects_barrier()
        out[tag + "_loss"] = float(m["loss"])
        out[tag + "_gnorm"] = float(m["grad_norm"])
        for path, v in jax.tree_util.tree_flatten_with_path(p1)[0]:
            out[tag + "_p_" + ".".join(str(k.key) for k in path)] = \\
                np.asarray(v)
        if tag == "41":
            for i, (p, o) in seen.items():
                out[f"packed_{{i}}"] = p
                out[f"voted_{{i}}"] = o
    grad = jax.jit(jax.grad(lambda p, b: rb.loss(p, b)[0]))
    for i in range(4):
        part = jax.tree.map(lambda x: x[i:i + 1], batch)
        for path, v in jax.tree_util.tree_flatten_with_path(
                grad(rp, part))[0]:
            out[f"u_{{i}}_" + ".".join(str(k.key) for k in path)] = \\
                np.asarray(v)
    np.savez({path!r}, **out)
    print("REF_OK")
""")


def _majority(words):
    """The bitwise majority (threshold D // 2 + 1) of D packed words."""
    bits = np.unpackbits(np.stack(words).view(np.uint8), axis=-1,
                         bitorder="little")
    maj = bits.sum(0) >= len(words) // 2 + 1
    return np.packbits(maj, axis=-1, bitorder="little").view(np.int32)


def _cli_losses(text):
    return [float(x) for x in re.findall(r"loss ([0-9.]+)", text)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_mp")
    # the CLI's start: the reference's reduced Qwen3 and AdamW state
    rcfg = RC.reduced(RC.get_config("qwen3_0p6b"))
    rb = rbuild(rcfg)
    rp = jax.jit(rb.init)(jax.random.PRNGKey(0))
    lr_fn = ropt.warmup_cosine(CLI_LR, max(10, STEPS // 20), STEPS)
    ropt_ = ropt.adamw(lr_fn)
    rs = ropt_.init(rp)
    ck = Checkpointer(str(tmp / "ck"), async_save=False)
    ck.save(0, (rp, rs))
    ck.wait()
    argv = ["--device", "cpu", "--steps", str(STEPS), "--seq", str(SEQ),
            "--batch", str(BATCH), "--log-every", "1", "--model-parallel",
            "2", "--init-from", str(tmp / "ck")]
    # the compressed step's start
    ccfg = dataclasses.replace(rcfg, dtype="float32", n_layers=N_LAYERS)
    crb = rbuild(ccfg)
    crp = jax.jit(crb.init)(jax.random.PRNGKey(0))
    cbatch = RSyntheticLM(ccfg.vocab_size, SEQ, BATCH, seed=3).batch(0)
    tcfg = dataclasses.replace(TC.reduced(TC.get_config("qwen3_0p6b")),
                               dtype="float32", n_layers=N_LAYERS)
    state = {n: p.detach().clone() for n, p in model_params_from_reference(
        tcfg, crp, device="cpu").named_parameters()}
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in cbatch.items()}
    code = _REF.format(repo=REPO, n_layers=N_LAYERS, seq=SEQ, batch=BATCH,
                       lr=R.LR, path=str(tmp / "ref.npz"))
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        ranks = ex.submit(run_ranks, R.train_mp, 4, argv,
                          (state, tbatch, N_LAYERS), timeout=400)
        ref = ex.submit(subprocess.run, [sys.executable, "-c", code],
                        capture_output=True, text=True, timeout=400)
        # the reference's steps from the checkpoint on the CLI's batches
        data = SyntheticLM.for_cell(
            TC.reduced(TC.get_config("qwen3_0p6b")),
            TC.ShapeConfig("cli", SEQ, BATCH, "train"), device="cpu")
        step = jax.jit(rmake_train_step(rb, ropt_))
        want, p, s = [], rp, rs
        for i in range(STEPS):
            b = {k: np.asarray(v) for k, v in data.batch(i).items()}
            p, s, m = step(p, s, jnp.int32(i), b)
            want.append(float(m["loss"]))
        got = ranks.result()
        r = ref.result()
    assert "REF_OK" in r.stdout, r.stderr[-3000:]
    return got, want, dict(np.load(tmp / "ref.npz"))


def test_train_cli_model_parallel_matches_the_reference(runs):
    got, want, _ = runs
    text = got[0]["cli"]
    assert "mesh={'data': 2, 'model': 2}" in text
    losses = _cli_losses(text)
    assert len(losses) == STEPS
    for g, w in zip(losses, want):
        assert abs(g - w) < 1e-2 * abs(w), (losses, want)
    assert all(r["cli"] == "" for r in got[1:])      # rank 0 prints


def _u_leaves(ref, i):
    return {k[len(f"u_{i}_"):]: v for k, v in ref.items()
            if k.startswith(f"u_{i}_")}


def test_compressed_votes_bit_for_bit(runs):
    got, _, ref = runs
    # the words as int32 bit patterns (the reference's are uint32)
    packed = [r["comp41"]["packed"].view(np.int32) for r in got]
    voted = [r["comp41"]["voted"].view(np.int32) for r in got]
    rpacked = [ref[f"packed_{i}"].reshape(1, -1).view(np.int32)
               for i in range(4)]
    rvoted = [ref[f"voted_{i}"].reshape(1, -1).view(np.int32)
              for i in range(4)]
    W = rpacked[0].shape[-1]
    for i in range(4):
        assert packed[i].shape == (1, W) and voted[i].shape == (1, W)
        # every rank holds the same votes, the majority of the signs
        np.testing.assert_array_equal(voted[i], _majority(packed))
        np.testing.assert_array_equal(rvoted[i], _majority(rpacked))
    # the packed signs agree but where u is near 0 (the leaves are
    # packed in the same sorted order, float32, padded to 32 lanes)
    for i in range(4):
        loud = np.ones(32 * W, bool)
        off = 0
        for _, v in sorted(_u_leaves(ref, i).items()):
            a = np.abs(v.reshape(-1))
            loud[off:off + a.size] = a >= SIGN_FRAC * a.max()
            off += a.size
        bits = np.unpackbits(packed[i].view(np.uint8), bitorder="little")
        rbits = np.unpackbits(rpacked[i].view(np.uint8), bitorder="little")
        assert (bits != rbits)[loud].sum() == 0, i
        # the votes differ only where an input bit did
        vb = np.unpackbits(voted[i].view(np.uint8), bitorder="little")
        rvb = np.unpackbits(rvoted[i].view(np.uint8), bitorder="little")
        differs = np.zeros_like(loud)
        for j in range(4):
            differs |= np.unpackbits(packed[j].view(np.uint8),
                                     bitorder="little") != \
                np.unpackbits(rpacked[j].view(np.uint8), bitorder="little")
        assert not ((vb != rvb) & ~differs).any(), i


@pytest.mark.parametrize("tag", ["41", "22"])
def test_compressed_step_matches_the_reference(runs, tag):
    got, _, ref = runs
    for rank, r in enumerate(got):
        m = r["comp" + tag]
        # the loss is the data ranks' mean; the grad norm each rank's own
        # (the reference returns its first device's)
        checks = [("loss", ref[tag + "_loss"])]
        if rank == 0:
            checks.append(("grad_norm", ref[tag + "_gnorm"]))
        for key, want in checks:
            assert abs(m[key] - float(want)) < 1e-4 * abs(float(want)), key
        model = {n: torch.from_numpy(v) for n, v in m["params"].items()}
        u = {}
        for i in range(4):
            for k, v in _u_leaves(ref, i).items():
                u[k] = u.get(k, 0) + np.abs(v)
        for leaf in leaves(model):
            g = leaf.gather(model).numpy()
            w = ref[f"{tag}_p_{leaf.name}"]
            err = np.abs(g - w) / np.abs(w).max()
            quiet = u[leaf.name] < SIGN_FRAC * u[leaf.name].max()
            assert not ((err >= 1e-4) & ~quiet).any(), (tag, leaf.name)
