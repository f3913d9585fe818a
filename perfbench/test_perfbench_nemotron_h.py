"""The Nemotron-H prefill cell on the CPU at a tiny size: the port's
prefill against the plain float32 reference, the float8 control and the
planted faults (an expert dropped, the selection bias ignored, RoPE
applied), with the cell's limit; the configuration, the weight drawer
and the FLOP counts. The weights and ids come from the seed as on the
card."""
import json
import time
from pathlib import Path

import pytest
import torch

from perfbench import control_nemotron_h, harness, lm
from perfbench.reference import nemotron_h as ref

ROOT = Path(__file__).resolve().parent
CELL = "nemotron3_nano.prefill"
#: every block kind, 2 B / C groups, 8 experts top 2; a hidden size at
#: which the random model's attention is sharp enough for RoPE to show
TINY = {"hidden_size": 1024, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 16,
        "moe_intermediate_size": 32, "moe_shared_expert_intermediate_size": 48,
        "intermediate_size": 32, "n_routed_experts": 8,
        "num_experts_per_tok": 2, "ssm_state_size": 16, "mamba_head_dim": 8,
        "mamba_num_heads": 8, "n_groups": 2, "chunk_size": 8,
        "vocab_size": 512, "hybrid_override_pattern": "MEM*E",
        "num_hidden_layers": 5, "prompts": 2, "prompt_len": 32,
        "sampled_requests": 2}
SEED = 2**31 + 29


def _files():
    spec = harness.cell_spec(harness.load_manifest(), CELL)
    return (spec, harness.load_json(ROOT / "configs" / f"{spec['config']}.json"),
            harness.load_json(ROOT / "traffic" / f"{spec['traffic']}.json"),
            harness.load_module(ROOT / "drivers" / f"{spec['driver']}.py"))


def _limits():
    return json.loads((ROOT / "cells" / f"{CELL}.json").read_text())["limits"]


def test_configuration_is_the_published_one_and_the_ports():
    spec, cfg, traffic, driver = _files()
    catalog = {   # the catalog entry's numbers, as published
        "hidden_size": 2688, "num_hidden_layers": 52, "mamba_num_heads": 64,
        "mamba_head_dim": 64, "n_groups": 8, "ssm_state_size": 128,
        "conv_kernel": 4, "chunk_size": 128, "n_routed_experts": 128,
        "num_experts_per_tok": 6, "moe_intermediate_size": 1856,
        "moe_shared_expert_intermediate_size": 3712,
        "routed_scaling_factor": 2.5, "num_attention_heads": 32,
        "num_key_value_heads": 2, "head_dim": 128, "vocab_size": 131072}
    assert {k: cfg[k] for k in catalog} == catalog and cfg["reduced"] == []
    port = driver.port_config(cfg)
    for key, field in driver.FIELDS.items():
        assert getattr(port, field) == cfg[key], key
    assert not port.use_rope and port.dropless and port.router == "sigmoid"
    assert port.padded_vocab == lm.padded(cfg["vocab_size"]) == 131072


@pytest.mark.parametrize("change", [
    {"n_group": 2}, {"mlp_hidden_act": "silu"}, {"tie_word_embeddings": True},
    {"norm_topk_prob": False}, {"sliding_window": 4096}, {"moe_latent_size": 1024}])
def test_configuration_the_port_cannot_run_is_refused(change):
    _, cfg, _, driver = _files()
    with pytest.raises(ValueError):
        driver.port_config({**cfg, **change})


def test_weights_are_seeded_and_shaped_as_the_port_holds_them():
    spec, cfg, traffic, driver = _files()
    cfg = driver.sized(cfg, TINY)
    port = driver.port_config(cfg)
    model = driver.load_model(port, cfg, SEED, "cpu")
    draw = driver.reference_drawer(cfg, port.padded_vocab, SEED, "cpu")
    for name, p in model.named_parameters():
        assert torch.equal(p.float(), draw(name)), name
    bias = draw("blocks.1.moe.e_bias")
    assert 0.1 < float(bias.std()) < 0.3
    dt = torch.nn.functional.softplus(draw("blocks.0.ssm.dt_bias"))
    assert float(dt.min()) >= 1e-4 and float(dt.max()) <= 0.1 + 1e-6
    a = torch.exp(draw("blocks.0.ssm.a_log"))
    assert 1 <= float(a.min()) and float(a.max()) <= 16


def test_flops_of_the_published_model():
    _, cfg, _, driver = _files()
    per = driver.block_params(cfg)
    assert per["M"] == 2688 * (2 * 4096 + 2 * 8 * 128 + 64) + 4096 * 2688
    assert per["E"] == 2688 * 128 + 6 * 2 * 2688 * 1856 + 2 * 2688 * 3712
    assert per["*"] == 2 * 2688 * 4096 + 2 * 2688 * 256
    active = 23 * per["M"] + 23 * per["E"] + 6 * per["*"]
    assert active == 2_874_482_688
    scan = driver.scan_flops_per_token(cfg)
    assert scan == 2 * (8 * 128 * 64 + 64 * 64 * 64 + 2 * 64 * 64 * 128)
    f = driver.prefill_flops(cfg, [8192] * 4)
    attention = 2 * 6 * 32 * 128 * 8192 * 8192
    assert f["attention"] == 4 * attention
    assert f["model"] == 4 * ((2 * active + 23 * scan) * 8192
                              + 2 * 2688 * 131072 + attention)


@pytest.mark.parametrize("trace", [False, True])
def test_cell_is_correct_on_the_cpu(single_thread, trace):
    out = harness.run_cell(CELL, SEED, 1.0, trace, time.perf_counter(),
                           device="cpu", overrides=TINY)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0
    if trace:
        assert {"moe_ms.prefill", "ssm_ms.prefill"} <= set(out["metrics"])
    else:
        assert set(out["metrics"]) == {"prefill_tokens_per_s", "setup_s"}


def test_replay_that_serves_other_ids_is_not_correct(single_thread):
    """The check reads the sampled requests served again: one whose ids
    differ from the window's fails ``replay_mismatch``; the requests'
    blocks are read at every batch slot in turn."""
    spec, cfg, traffic, driver = _files()
    bench = driver.Bench(cfg, traffic, spec, SEED, "cpu", TINY)
    bench.setup()
    for i in range(2):
        bench.unit(i)
    bench.served[1] = (bench.served[1] + 1) % cfg["vocab_size"]
    bench.close()
    assert sorted(r.slot for r in bench.replays.values()) == [0, 1]
    checks = bench.check()
    assert checks["replay_mismatch"] == (1.0, 0)
    assert checks["block_gap"][0] <= checks["block_gap"][1]


@pytest.fixture(scope="module")
def single_thread():
    """One host thread: the suite runs several test files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def readings(single_thread):
    """The program's reading, the float8 control's, the served-id faults'
    and every planted fault's, by kind (one seed)."""
    spec, cfg, traffic, driver = _files()
    rows = control_nemotron_h.readings(
        spec, cfg, traffic, driver, SEED, True,
        tuple(control_nemotron_h.FAULTS), device="cpu", overrides=TINY)
    return {r["kind"]: r for r in rows}


def _fails(row):
    return any(row.get(k) is not None and row[k] > v
               for k, v in _limits().items())


def test_control_and_served_id_faults_fail_a_limit(readings):
    assert not _fails(readings["program"]), readings["program"]
    for kind in ("control_fp8", "fault_altered", "fault_half_batch"):
        assert _fails(readings[kind]), readings[kind]
    assert readings["control_fp8"]["route_gap"] > _limits()["route_gap"]


#: the number that catches each planted fault
CAUGHT_BY = {"fault_expert_dropped": "block_gap",
             "fault_bias_ignored": "route_gap",
             "fault_rope_applied": "block_gap"}


@pytest.mark.parametrize("fault", sorted(control_nemotron_h.FAULTS))
def test_planted_fault_fails_a_limit(readings, fault):
    number = CAUGHT_BY[fault]
    assert readings[fault][number] > _limits()[number], readings[fault]


def test_moe_block_is_compared_on_the_programs_experts():
    """The reference MoE on given experts, and the route gap: 0 on the
    reference's own choice, the tie's width where two experts swap."""
    _, cfg, _, driver = _files()
    cfg = driver.sized(cfg, TINY)
    draw = driver.reference_drawer(cfg, lm.padded(cfg["vocab_size"]), SEED,
                                   "cpu")
    w = ref.block_weights(draw, 1, "E")
    x = torch.randn(40, cfg["hidden_size"],
                    generator=torch.Generator().manual_seed(3))
    with ref.full_float32():
        y, sel = ref.moe(x, w, cfg)
        assert torch.equal(ref.moe(x, w, cfg, sel=sel)[0], y)
        assert ref.route_gap(x, w, cfg, sel) == 0.0
        pick = torch.sigmoid(x @ w["router"]) + w["e_bias"]
        order = pick.argsort(-1, descending=True)
        k = cfg["num_experts_per_tok"]
        swapped = torch.cat([order[:, :k - 1], order[:, k:k + 1]], 1)
        tie = pick.gather(1, order[:, k - 1:k + 1])
        assert ref.route_gap(x, w, cfg, swapped) == pytest.approx(
            float((tie[:, 0] - tie[:, 1]).max()))
        assert not torch.allclose(ref.moe(x, w, cfg, sel=swapped)[0], y)
