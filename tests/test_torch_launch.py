"""Port parity: the mesh-free launch modules against the JAX package's.

`launch.plans.plan_for` and `launch.roofline.model_flops` equal the
reference's for every cell of `configs.base.cells` (exactly: a dataclass
and integer arithmetic in float64), and `useful_flops` leaves out of
it the token table's lookup and a prefill's head at all but the last
position; `launch.report` prints the
reference's strings for the same rows; `Roofline`'s properties equal
the reference's for the same counts when its card carries the
reference's peaks; `hw` picks the H100 row by name and refuses any other;
and `dist.sharding`'s context (`axis_rules`, `constrain`, `strip_axes`,
`resolve_spec` under a context) behaves as the reference's does.
"""
import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.configs.base as RC  # noqa: E402
import repro.dist.sharding as rsh  # noqa: E402
from repro import hw as rhw  # noqa: E402
from repro.launch import plans as rplans  # noqa: E402
from repro.launch import report as rreport  # noqa: E402
from repro.launch import roofline as rroof  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import hw  # noqa: E402
from repro_torch.dist import sharding as tsh  # noqa: E402
from repro_torch.launch import plans, report, roofline  # noqa: E402

CELLS = RC.cells()


def test_cells_are_the_references():
    assert TC.cells() == CELLS
    assert TC.cells(include_skips=True) == RC.cells(include_skips=True)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_plan_and_model_flops_equal_the_reference(arch, shape):
    rcfg, cfg = RC.get_config(arch), TC.get_config(arch)
    rshape, tshape = RC.SHAPES[shape], TC.SHAPES[shape]
    assert dataclasses.asdict(plans.plan_for(cfg, tshape)) == \
        dataclasses.asdict(rplans.plan_for(rcfg, rshape))
    over = {"remat": "dots", "grad_accum": 3, "notes": "x"}
    assert dataclasses.asdict(plans.plan_for(cfg, tshape, over)) == \
        dataclasses.asdict(rplans.plan_for(rcfg, rshape, over))
    assert roofline.model_flops(cfg, tshape) == \
        rroof.model_flops(rcfg, rshape)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_useful_flops_leave_out_the_table_and_the_prefill_head(arch, shape):
    cfg, tshape = TC.get_config(arch), TC.SHAPES[shape]
    full = rroof.model_flops(RC.get_config(arch), RC.SHAPES[shape])
    useful = roofline.useful_flops(cfg, tshape)
    table = cfg.padded_vocab * cfg.d_model
    B, S = tshape.global_batch, tshape.seq_len
    left_out = {"train": 6 * table * B * S,
                "prefill": 2 * table * B * S + 2 * table * (B * S - B),
                "decode": 2 * table * B}[tshape.kind]
    assert 0 < useful < full
    assert useful == pytest.approx(full - left_out, rel=1e-12)


def _rows():
    """Synthetic report rows: ok cells of both pods' meshes and failures."""
    rng = np.random.default_rng(3)
    rows = []
    for i, (arch, shape) in enumerate(CELLS[:9]):
        t = rng.uniform(1e-4, 2.0, 3)
        rows.append({
            "arch": arch, "shape": shape,
            "mesh": "16x16" if i % 2 else "2x16x16", "status": "ok",
            "t_compute_s": t[0], "t_memory_s": t[1], "t_collective_s": t[2],
            "dominant": ["compute", "memory", "collective"][int(t.argmax())],
            "useful_flops_ratio": rng.uniform(0.2, 1.0),
            "roofline_fraction": rng.uniform(0.0, 0.8),
            "memory_analysis": ({"temp_size_in_bytes": int(rng.integers(
                1, 1 << 36))} if i % 3 else None)})
    rows.append({"arch": "qwen3_8b", "shape": "decode_32k", "mesh": "16x16",
                 "status": "lower failed: RESOURCE_EXHAUSTED while "
                           "allocating a very long buffer"})
    rows.append({"arch": "zamba2_2p7b", "shape": "long_500k",
                 "status": "skip"})
    return rows


def test_report_prints_the_references_strings(tmp_path):
    rows = _rows()
    assert report.markdown_table(rows) == rreport.markdown_table(rows)
    assert report.summarize(rows) == rreport.summarize(rows)
    assert report.summarize([]) == rreport.summarize([])
    for b in (None, 0, 5 * 2**30):
        assert report.fmt_bytes(b) == rreport.fmt_bytes(b)
    for i, r in enumerate(rows):
        (tmp_path / f"cell_{i:02d}.json").write_text(json.dumps(r))
    assert report.load(str(tmp_path)) == rreport.load(str(tmp_path))


REF_CARD = hw.Card(name="the reference's peaks",
                   bf16_flops_per_s=rhw.PEAK_FLOPS, f32_flops_per_s=0.0,
                   hbm_bytes_per_s=rhw.HBM_BW, nvlink_bytes_per_s=rhw.ICI_BW,
                   int32_lanes_per_sm=0, smem_bytes_per_clk=0)


@pytest.mark.parametrize("counts", [
    (3.1e15, 2.2e13, 4.5e11, 1.1e12, 4),
    (1e12, 5e13, 0.0, 7e11, 1),
    (2e14, 1e9, 9e13, 1e9, 256),
    (0.0, 0.0, 0.0, 0.0, 1)])
def test_roofline_equals_the_reference_at_its_peaks(counts):
    flops, nbytes, coll, dot, chips = counts
    cfg, rcfg = TC.get_config("qwen3_8b"), RC.get_config("qwen3_8b")
    mf = roofline.model_flops(cfg, TC.SHAPES["train_4k"])
    kw = dict(arch="qwen3_8b", shape="train_4k", mesh="16x16", chips=chips,
              hlo_flops=flops, hlo_bytes=nbytes, collective_bytes=coll,
              collective_by_kind={"all-reduce": {"count": 3}},
              model_flops_=mf, bytes_per_device=1.5e9, dot_bytes=dot)
    got = roofline.Roofline(**kw, card=REF_CARD).to_dict()
    want = rroof.Roofline(**kw).to_dict()
    assert got == want
    assert mf == rroof.model_flops(rcfg, RC.SHAPES["train_4k"])


def test_analyze_prices_a_cost_against_a_card():
    from repro_torch.launch.hlocost import Cost

    cfg = TC.get_config("qwen3_0p6b")
    shape = TC.ShapeConfig("t", 4096, 8, "train")
    cost = Cost(flops=2.1e14, bytes=2.4e12, dot_bytes=2.3e11)
    r = roofline.analyze(cost, cfg, shape, "1", 1, "qwen3_0p6b",
                         bytes_per_device=7.5e9, card=hw.H100_SXM)
    d = r.to_dict()
    assert d["t_compute_s"] == pytest.approx(2.1e14 / 989e12)
    assert d["t_memory_s"] == pytest.approx(2.4e12 / 3.35e12)
    assert d["t_memory_floor_s"] == pytest.approx(2.3e11 / 3.35e12)
    assert d["t_collective_s"] == 0 and d["collective_by_kind"] == {}
    assert d["dominant"] == "memory" and d["bytes_per_device"] == 7.5e9
    assert d["useful_flops_ratio"] == pytest.approx(
        roofline.model_flops(cfg, shape) / 2.1e14)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            roofline.analyze(cost, cfg, shape, "1", 1, "qwen3_0p6b")


def test_hw_picks_the_h100_row_by_name():
    card = hw.lookup("NVIDIA H100 80GB HBM3")
    assert card is hw.H100_SXM
    assert card.flops_per_s("bfloat16") == 989e12
    assert card.flops_per_s(torch.float32) == 67e12
    assert card.hbm_bytes_per_s == 3.35e12
    assert card.nvlink_bytes_per_s == 450e9
    assert (card.int32_lanes_per_sm, card.smem_bytes_per_clk) == (64, 128)
    with pytest.raises(ValueError, match="no peak"):
        card.flops_per_s("float16")
    for name in ("NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", "TPU v5e", ""):
        with pytest.raises(ValueError, match="no peaks for card"):
            hw.lookup(name)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            hw.current()


@pytest.mark.parametrize("table", ["DEFAULT_RULES", "SP_RULES",
                                   "DECODE_SP_RULES", "DP_RULES"])
def test_strip_axes(table):
    got = tsh.strip_axes(getattr(tsh, table), ("data", "pod"))
    assert got["batch"] == ()
    assert got["vocab"] == ("model",)
    assert got == rsh.strip_axes(getattr(rsh, table), ("data", "pod"))


def test_constrain_identity_outside_context():
    x = torch.ones(4, 4)
    assert tsh.constrain(x, "batch", None) is x
    y = jnp.ones((4, 4))
    assert rsh.constrain(y, "batch", None) is y
    assert tsh.current_mesh() is None and tsh.current_rules() is None
    mesh = {"data": 2, "model": 4}
    with tsh.axis_rules(mesh):
        assert tsh.current_mesh() == mesh
        assert tsh.current_rules() is tsh.DEFAULT_RULES
        # axis sizes alone place nothing: constrain needs a DeviceMesh
        with pytest.raises(ValueError, match="DeviceMesh"):
            tsh.constrain(x, "batch", None)
        # a disabled context inside: the identity again
        with tsh.axis_rules(None):
            assert tsh.current_mesh() is None
            assert tsh.constrain(x, "batch", None) is x
        assert tsh.current_mesh() == mesh
    assert tsh.current_mesh() is None


def test_resolve_spec_reads_the_enclosing_rules():
    mesh = {"data": 2, "model": 4}
    shape, names = (8, 4096, 64), ("batch", "seq", "heads")
    assert tsh.resolve_spec(shape, names, mesh) == ("data", None, "model")
    with tsh.axis_rules(mesh, tsh.SP_RULES):
        # SP shards seq over model, so heads may not take it again
        assert tsh.resolve_spec(shape, names, mesh) == \
            ("data", "model", None)
        # explicit rules win over the context's
        assert tsh.resolve_spec(shape, names, mesh, tsh.DEFAULT_RULES) == \
            ("data", None, "model")
    assert tsh.resolve_spec(shape, names, mesh) == ("data", None, "model")
