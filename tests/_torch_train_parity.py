"""Shared cases of the training-step parity tests: in float32
`test_torch_train_step.py` (loss, gradients, sgd),
`test_torch_train_step_adaptive.py` (adamw, adafactor) and
`test_torch_train_step_signum.py`; the same three with ``_bf16`` in bf16,
split by optimizer so that each file stays short on its test worker;
`test_torch_train_step_bias.py`, a QKV-bias model in float32; one
file per other trained family, `test_torch_train_step_{ssm,hybrid,
encdec,vlm}.py` (reduced Mamba2, Zamba2, SeamlessM4T, Llama-3.2-Vision);
the MoE family's three, `test_torch_train_step_moe{,_kimi,_steps}.py`
(reduced Llama-4 Maverick and Kimi K2, whose routing `check_routes`
holds first); and ``remat="dots"`` (`dots_case`) in
`test_torch_remat_dots{,_families}.py`.

The JAX package's reduced Qwen3-0.6B (4 layers, d_model 128, 4 heads, 2
KV heads, head_dim 32, vocab 512 padded to 2,048) and its parameters
(``build(cfg).init(PRNGKey(0))``) are carried into the port with
`convert.model_params_from_reference`; both packages take the JAX
package's `SyntheticLM` batches (seq 16, batch 4; the other families'
reduced configs take seq 40 and, for the enc-dec and VLM families, the
frontend's bf16 stub embeddings, `SyntheticLM.for_cell`). Held, in
float32 and
bf16, at ``grad_accum`` 1 and 2: the loss and every gradient leaf of
`train.step.loss_and_grads` against ``jax.grad`` of ``bundle.loss``
(averaged in float32 over the microbatches, as the reference's scan
does), and for sgd / adamw / adafactor / signum one `make_train_step`
step from the same start (loss, ``grad_norm``, updated parameters), then
a second step resumed from the reference's state after its first
(`convert.opt_state_from_reference`), plus the port's own second step.

Tolerances: 1e-4 of the reference's largest magnitude per leaf in
float32 (the two sum in other orders), 0.05 in bf16 (one bf16 rounding
that lands the other way moves a value by 2^-8 of it; the bound
`tests/test_models.py` holds bf16 decode to prefill with). Sign-like
updates (AdamW's normalised step, Adafactor's unfactored first step and
signum's sign) turn a gradient difference near 0 into a step of about
``lr``: an element outside the tolerance must be one whose deciding
value (the gradient; for signum ``g + error feedback``) is below
`SIGN_FRAC` of its leaf's largest (in bf16 the gradient tolerance
itself), and such elements are counted (at
most `MAX_EXEMPT` of a leaf, none for SGD). The QKV-bias cases also
leave out the noise-level gradients `noise_exempt` names, and only those
cases. A bf16 gradient leaf is held to the reference's own float32
gradient where the reference's bf16 one strays from it
(`loss_and_grads_case`). The reference runs its
pure-jnp attention here; its Pallas flash backward is held to the
port's in `tests/test_torch_flashattn_bwd.py`.
"""
import contextlib
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

import repro.configs.base as RC
import repro.optim as ropt
from repro.data import SyntheticLM as RSyntheticLM
from repro.models import build as rbuild
from repro.models import moe as rmoe
from repro.train import make_train_step as rmake_train_step
from repro_torch import configs as TC
from repro_torch import optim as topt
from repro_torch.convert import (model_params_from_reference,
                                 opt_state_from_reference)
from repro_torch.models import build
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import MoEBlock, layer_kinds
from repro_torch.optim.optimizers import leaves
from repro_torch.train import make_train_step
from repro_torch.train.step import loss_and_grads

TOL = {"float32": 1e-4, "bfloat16": 0.05}
#: noise-level gradients (`noise_exempt`): within NOISE_MULT of AdamW's eps
ADAM_EPS = 1e-8
NOISE_MULT = 10
SIGN_FRAC = {"float32": 1e-3, "bfloat16": 0.05}
MAX_EXEMPT = 0.01
LR = {"sgd": 0.05, "adamw": 1e-3, "adafactor": 1e-3, "signum": 1e-3}
OPTS = list(LR)
SIGN_LIKE = {"adamw", "adafactor", "signum"}


#: batch sequence by family: the dense cases' 16; 40 for the others, not
#: a multiple of the reduced SSD chunk of 16, so the scan's padded tail is
#: in the backward
SEQ = {"dense": 16}
SEQ_OTHER = 40


@functools.lru_cache(None)
def _setup(dtype, arch="qwen3_0p6b", cf=None):
    """The reduced configs of both packages (``cf``: an MoE capacity
    factor in place of the config's), the reference's bundle,
    parameters, two batches and jitted gradient."""
    kw = {"dtype": dtype} if cf is None else {"dtype": dtype,
                                              "capacity_factor": cf}
    rcfg = dataclasses.replace(RC.reduced(RC.get_config(arch)), **kw)
    cfg = dataclasses.replace(TC.reduced(TC.get_config(arch)), **kw)
    rb = rbuild(rcfg)
    rp = rb.init(jax.random.PRNGKey(0))
    # with the frontend's stub embeddings (frames / patches) where the
    # family has one
    data = RSyntheticLM.for_cell(
        rcfg, RC.ShapeConfig("parity", SEQ.get(rcfg.family, SEQ_OTHER), 4,
                             "train"), seed=7)
    batches = [data.batch(i) for i in range(2)]
    grad = jax.jit(jax.grad(lambda p, b: rb.loss(p, b)[0]))
    return cfg, rb, rp, batches, grad


def _torch_batch(batch):
    """numpy copies of a reference batch as tensors; the bf16 frontend
    embeddings exactly, through float32."""
    out = {}
    for k, v in batch.items():
        if v.dtype == jnp.bfloat16:
            out[k] = torch.from_numpy(np.asarray(v, np.float32)).to(
                torch.bfloat16)
        else:
            out[k] = torch.from_numpy(np.array(v))
    return out


def _ref_grads(grad, params, batch, accum):
    """The reference's gradients of one batch: averaged in float32 over
    ``accum`` microbatches (`repro.train.step`'s scan)."""
    if accum == 1:
        return grad(params, batch)
    mbs = [jax.tree.map(lambda x, i=i: x.reshape(accum, -1, *x.shape[1:])[i],
                        batch) for i in range(accum)]
    acc = None
    for mb in mbs:
        g = jax.tree.map(lambda x: x.astype(jnp.float32), grad(params, mb))
        acc = g if acc is None else jax.tree.map(jnp.add, acc, g)
    return jax.tree.map(lambda x: x / accum, acc)


@functools.lru_cache(None)
def _first_grads(dtype, arch, accum, cf=None):
    """The reference's gradients of the first batch at its initial
    parameters, which every case of a process shares: computed once."""
    _, _, rp, batches, grad = _setup(dtype, arch, cf)
    return _ref_grads(grad, rp, batches[0], accum)


def _flat(tree):
    """Reference tree -> {port leaf name: float32 numpy}."""
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[".".join(str(k.key) for k in path)] = np.asarray(v, np.float32)
    return out


def _f32(x):
    return x.detach().float().numpy()


def _close(got, want, tol, what, exempt=None, noise=None):
    """Every element within ``tol`` of the reference's largest magnitude,
    or exempt; returns how many exempt elements were outside it (at most
    `MAX_EXEMPT` of the leaf). Elements in ``noise`` (`noise_exempt`) are
    left out of both, and must only be finite."""
    assert np.isfinite(got).all(), f"{what}: not finite"
    err = np.abs(got - want) / (np.abs(want).max() + 1e-12)
    off = err >= tol
    if noise is not None:
        off = off & ~noise
    if exempt is not None:
        assert off.mean() <= MAX_EXEMPT, (what, off.mean())
        off = off & ~exempt
    worst = float(np.where(off, err, 0.0).max())
    assert not off.any(), f"{what}: max error {worst:.3g} of the " \
        f"reference's max"
    return int(((err >= tol) & (True if noise is None else ~noise)).sum())


def _ref_opt(name):
    lr = ropt.constant(LR[name])
    if name == "sgd":
        return ropt.sgd(lr)
    if name == "signum":
        return ropt.signum(lr)
    return getattr(ropt, name)(lr)


def _port_opt(name):
    return topt.get_optimizer(name, topt.constant(LR[name]))


def _deciders(name, grads, gnorm, state):
    """Per leaf, the values whose sign decides a sign-like update: the
    clipped gradient (plus signum's error feedback)."""
    scale = min(1.0, 1.0 / max(gnorm, 1e-9))
    out = {k: g * scale for k, g in _flat(grads).items()}
    if name == "signum":
        for k, e in _flat(state["err"]).items():
            out[k] = out[k] + e
    return out


def noise_exempt(name, deciders):
    """Per leaf, the elements whose update a noise-level gradient decides,
    for the models whose gradients sink into rounding noise (the key bias
    of QKV-bias models barely moves the scores: a fifth of its gradients
    lie below 1e-8). A gradient within `NOISE_MULT` x `ADAM_EPS` (1e-7)
    of 0 is noise: the two packages' sums differ there by about 1e-10,
    which AdamW's g / (|g| + eps) turns into steps of opposite sign. So
    AdamW and Adafactor exempt every element whose (clipped) reference
    gradient is noise, and Adafactor also every element of a column whose
    factored normaliser (the mean of g^2 over axis -2) such gradients set,
    i.e. whose gradient RMS over that axis is within the same level.
    Other optimizers exempt nothing."""
    level = NOISE_MULT * ADAM_EPS
    out = {}
    if name not in ("adamw", "adafactor"):
        return out
    for k, d in deciders.items():
        out[k] = np.abs(d) <= level
        if name == "adafactor" and d.ndim >= 2:
            col = np.sqrt((d.astype(np.float64) ** 2).mean(-2))
            out[k] = out[k] | (col[..., None, :] <= level)
    return out


def _check_params(model, ref_params, name, deciders, dtype, what,
                  noise=None):
    """Hold every updated parameter leaf to the reference's; returns the
    number of exempt elements outside the tolerance (``noise``: per leaf,
    the elements `noise_exempt` leaves out)."""
    named = dict(model.named_parameters())
    want = _flat(ref_params)
    n_off = 0
    for leaf in leaves(named):
        got = _f32(leaf.gather(named))
        exempt = None
        if name in SIGN_LIKE:
            d = np.abs(deciders[leaf.name])
            exempt = d < SIGN_FRAC[dtype] * d.max()
        n_off += _close(got, want[leaf.name], TOL[dtype],
                        f"{what} {leaf.name}", exempt,
                        None if noise is None else noise.get(leaf.name))
    return n_off


@contextlib.contextmanager
def _one_thread():
    """The port's side of a case on one intra-op thread, restored after:
    its tensors are tiny, and the test workers run side by side, where
    every extra thread of every worker contends for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@functools.lru_cache(None)
def _exact_grads(arch, accum, cf=None):
    """The reference's float32 gradients of the first batch at its bf16
    parameters (cast up): the bf16 model's gradients without its
    roundings."""
    _, _, rp, batches, _ = _setup("bfloat16", arch, cf)
    grad = _setup("float32", arch, cf)[4]
    rp32 = jax.tree.map(lambda x: x.astype(jnp.float32), rp)
    return _ref_grads(grad, rp32, batches[0], accum)


def _rel_max(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@_one_thread()
def loss_and_grads_case(dtype, accum, arch="qwen3_0p6b", cf=None,
                        check=None):
    """Loss, metrics and every gradient leaf of one batch (``cf``: an MoE
    capacity factor; ``check(cfg, rb, rp, bundle, model, batch)``: run
    before the gradients, as the MoE cases' routing check). In bf16 a
    leaf whose reference gradient lies `TOL` or more from the
    reference's own float32 gradient at the same parameters
    (`_exact_grads`; Zamba2's ``groups.ssm.d_skip``, at 0.089 of its
    largest value where the port's lies at 0.011) is held to that
    float32 gradient instead, at the same tolerance."""
    cfg, rb, rp, batches, grad = _setup(dtype, arch, cf)
    want = _flat(_first_grads(dtype, arch, accum, cf))
    bundle = build(cfg, device="cpu")
    model = model_params_from_reference(cfg, rp, device="cpu")
    if check is not None:
        check(cfg, rb, rp, bundle, model, batches[0])
    loss, metrics, grads = loss_and_grads(bundle, model,
                                          _torch_batch(batches[0]), accum)
    # the reference's step averages its microbatches' losses (for the
    # dense families that is the whole batch's loss; an MoE layer's
    # capacity and load-balancing loss depend on the microbatch)
    ref_loss, ref_metrics = rb.loss(rp, batches[0])
    if accum > 1:
        ref_loss = sum(rb.loss(rp, jax.tree.map(
            lambda x, i=i: x.reshape(accum, -1, *x.shape[1:])[i],
            batches[0]))[0] for i in range(accum)) / accum
    assert abs(float(loss) - float(ref_loss)) < TOL[dtype] * abs(
        float(ref_loss))
    assert set(metrics) == ({"xent", "aux"} if accum == 1 else set())
    if accum == 1:
        # the MoE load-balancing loss (0 for the other families)
        ref_aux = float(ref_metrics["aux"])
        assert abs(float(metrics["aux"]) - ref_aux) <= TOL[dtype] * abs(
            ref_aux)
    named = dict(model.named_parameters())
    for leaf in leaves(named):
        g = leaf.gather(grads)
        # one microbatch keeps each parameter's dtype (the SSM's a_log,
        # d_skip and dt_bias are float32 in a bf16 model)
        assert g.dtype == (torch.float32 if accum > 1
                           else leaf.gather(named).dtype)
        w = want[leaf.name]
        if dtype == "bfloat16" and _rel_max(_f32(g), w) >= TOL[dtype]:
            exact = _flat(_exact_grads(arch, accum, cf))[leaf.name]
            if _rel_max(w, exact) >= TOL[dtype]:
                w = exact
        _close(_f32(g), w, TOL[dtype], f"grad {leaf.name}")


@_one_thread()
def train_step_case(dtype, name, accum, arch="qwen3_0p6b", noise=False):
    """Two `make_train_step` steps of optimizer ``name``; ``noise``: leave
    out the elements `noise_exempt` names."""
    cfg, rb, rp, batches, grad = _setup(dtype, arch)
    tol = TOL[dtype]
    ropt_ = _ref_opt(name)
    rstep = jax.jit(rmake_train_step(rb, ropt_, grad_accum=accum))
    rs0 = ropt_.init(rp)
    rp1, rs1, rm1 = rstep(rp, rs0, jnp.int32(0), batches[0])
    rp2, rs2, rm2 = rstep(rp1, rs1, jnp.int32(1), batches[1])

    bundle = build(cfg, device="cpu")
    opt = _port_opt(name)
    step = make_train_step(bundle, opt, grad_accum=accum)
    model = model_params_from_reference(cfg, rp, device="cpu")
    state = opt.init(model)
    model, state, m1 = step(model, state, 0, _torch_batch(batches[0]))
    for k in ("loss", "grad_norm"):
        assert abs(float(m1[k]) - float(rm1[k])) < tol * abs(float(rm1[k]))
    dec = _deciders(name, _first_grads(dtype, arch, accum),
                    float(rm1["grad_norm"]), rs0)
    _check_params(model, rp1, name, dec, dtype, "step 1",
                  noise_exempt(name, dec) if noise else None)
    # the port's own second step: its loss
    _, _, m2 = step(model, state, 1, _torch_batch(batches[1]))
    assert abs(float(m2["loss"]) - float(rm2["loss"])) < tol * abs(
        float(rm2["loss"]))

    # the second step resumed from the reference's parameters and state
    model = model_params_from_reference(cfg, rp1, device="cpu")
    state = opt_state_from_reference(name, rs1, model)
    model, _, m2 = step(model, state, 1, _torch_batch(batches[1]))
    for k in ("loss", "grad_norm"):
        assert abs(float(m2[k]) - float(rm2[k])) < tol * abs(float(rm2[k]))
    dec = _deciders(name, _ref_grads(grad, rp1, batches[1], accum),
                    float(rm2["grad_norm"]), rs1)
    _check_params(model, rp2, name, dec, dtype, "step 2",
                  noise_exempt(name, dec) if noise else None)


# --------------------------------------------------------------------------
# the MoE family's routing (`test_torch_train_step_moe*.py`)
# --------------------------------------------------------------------------

#: a capacity factor at which both reduced MoE configs drop tokens
#: (capacity 8 against a mean load of 20 for Maverick, 16 against 40 for
#: Kimi K2)
DROP_CF = 0.25


def _ref_routes(rb, rp, batch, n_moe):
    """The reference's expert ids (T, k) per MoE layer on ``batch``, as
    its jitted gradient routes them (XLA's fusion can round bf16
    activations otherwise than an eager forward, and flip a near-tie):
    its router's top-k over the same float32 probabilities, read by a
    callback inside the jitted gradient's forward (the rematerialised
    forward in its backward routes the same)."""
    seen = []
    orig = rmoe.moe_ffn

    def spy(p, x, cfg):
        xt = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
        probs = jax.nn.softmax(xt @ p["router"], axis=-1)
        _, idx = jax.lax.top_k(probs, cfg.top_k)
        jax.debug.callback(lambda i: seen.append(np.asarray(i)), idx,
                           ordered=True)
        return orig(p, x, cfg)

    rmoe.moe_ffn = spy
    try:
        grad = jax.jit(jax.grad(lambda p, b: rb.loss(p, b)[0]))
        jax.block_until_ready(grad(rp, batch))
        jax.effects_barrier()
    finally:
        rmoe.moe_ffn = orig
    return seen[:n_moe]


def _port_routes(bundle, model, batch):
    """The port's (expert ids (T, k), router probabilities (T, E)) per
    MoE layer on ``batch``."""
    seen = []
    orig = tmoe.route

    def spy(router, xt, top_k):
        probs, gate, idx = orig(router, xt, top_k)
        seen.append((idx.numpy().copy(), probs.numpy().copy()))
        return probs, gate, idx

    tmoe.route = spy
    try:
        with torch.no_grad():
            bundle.loss(model, _torch_batch(batch))
    finally:
        tmoe.route = orig
    return seen


#: bf16: a token whose two candidate experts' router probabilities lie
#: within this share of each other is a near-tie, which one rounding of
#: the bf16 activations (2^-8 relative) may flip between the packages
NEAR_TIE = 0.02
#: and at most this share of the routed slots may be such flips
MAX_FLIPS = 0.02


def check_routes(cfg, rb, rp, bundle, model, batch, monkeypatch=None):
    """Both packages route every token of ``batch`` to the same experts
    in every MoE layer, and at a dropping capacity the dispatch drops
    slots. With ``monkeypatch`` (the bf16 case) a slot may differ where
    it is a near-tie (`NEAR_TIE`, at most `MAX_FLIPS` of the slots); the
    port's router is then pinned to the reference's ids for the rest of
    the test (its gates still its own probabilities at those ids), so
    that the gradients compare the same dispatch."""
    n_moe = layer_kinds(cfg).count("moe")
    want = _ref_routes(rb, rp, batch, n_moe)
    got = _port_routes(bundle, model, batch)
    assert len(want) == len(got) == n_moe, (len(want), len(got))
    T = batch["tokens"].size
    C = tmoe.expert_capacity(cfg, T)
    for layer, ((g, probs), w) in enumerate(zip(got, want)):
        assert g.shape == (T, cfg.top_k)
        if monkeypatch is None:
            np.testing.assert_array_equal(
                g, w, err_msg=f"MoE layer {layer} routes differently")
        else:
            rows = np.nonzero((g != w).any(-1))[0]
            assert len(rows) <= MAX_FLIPS * T, (layer, len(rows))
            for t in rows:
                pg = probs[t, g[t]].sum()
                pw = probs[t, w[t]].sum()
                assert abs(pg - pw) <= NEAR_TIE * max(pg, pw), \
                    (layer, t, g[t], w[t], pg, pw)
        counts = np.bincount(g.reshape(-1), minlength=cfg.n_experts)
        if cfg.capacity_factor == DROP_CF:
            assert np.maximum(counts - C, 0).sum() > 0, layer
    if monkeypatch is not None:
        routers = [b.moe.router for b in model.blocks()
                   if isinstance(b, MoEBlock)]
        pinned = {id(r): torch.from_numpy(np.array(w)).long()
                  for r, w in zip(routers, want)}
        orig = tmoe.route

        def route(router, xt, top_k):
            probs, _, _ = orig(router, xt, top_k)
            idx = pinned[id(router)]
            gate = probs.gather(-1, idx)
            gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
            return probs, gate, idx

        monkeypatch.setattr(tmoe, "route", route)


@functools.lru_cache(None)
def _ref_dots_grads(arch):
    """The reference's float32 loss and gradients of the first batch
    under ``remat="dots"``."""
    _, rb, rp, batches, _ = _setup("float32", arch)
    rbd = rbuild(rb.cfg, remat="dots")
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: rbd.loss(p, b)[0]))(rp, batches[0])
    return float(loss), _flat(grads)


@_one_thread()
def dots_case(arch):
    """``remat="dots"`` in float32: the loss and every gradient leaf equal
    the port's under "block" bit for bit (the policy changes what the
    backward recomputes, not what it computes) and the reference's under
    "dots" within `TOL`."""
    cfg, _, rp, batches, _ = _setup("float32", arch)
    model = model_params_from_reference(cfg, rp, device="cpu")
    batch = _torch_batch(batches[0])
    loss_d, _, grads_d = loss_and_grads(
        build(cfg, device="cpu", remat="dots"), model, batch)
    loss_b, _, grads_b = loss_and_grads(
        build(cfg, device="cpu", remat="block"), model, batch)
    assert torch.equal(loss_d, loss_b)
    assert set(grads_d) == set(grads_b)
    for name in grads_b:
        assert torch.equal(grads_d[name], grads_b[name]), name
    ref_loss, want = _ref_dots_grads(arch)
    assert abs(float(loss_d) - ref_loss) < TOL["float32"] * abs(ref_loss)
    named = dict(model.named_parameters())
    for leaf in leaves(named):
        _close(_f32(leaf.gather(grads_d)), want[leaf.name], TOL["float32"],
               f"grad {leaf.name}")
