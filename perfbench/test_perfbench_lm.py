"""The LM cells on the CPU at a tiny size: the port's training step and
prefill against the plain float32 reference, the float8 control and the
planted faults, with the cells' limits. The weights and ids come from
the seed as on the card."""
import json
import time
from pathlib import Path

import pytest
import torch

from perfbench import control, data, harness, lm
from perfbench.reference import qwen3 as ref

ROOT = Path(__file__).resolve().parent
TINY = {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "vocab_size": 512, "seq": 64, "global_batch": 4, "microbatches": 2,
        "prompts": 4, "prompt_len": 32, "sampled_requests": 6}
SEED = 2**31 + 29


def _files(cell):
    spec = harness.cell_spec(harness.load_manifest(), cell)
    return (spec, harness.load_json(ROOT / "configs" / f"{spec['config']}.json"),
            harness.load_json(ROOT / "traffic" / f"{spec['traffic']}.json"),
            harness.load_module(ROOT / "drivers" / f"{spec['driver']}.py"))


def _run(cell, trace=False):
    return harness.run_cell(cell, SEED, 1.0, trace, time.perf_counter(),
                            device="cpu", overrides=TINY)


def test_configuration_is_the_ports():
    cfg = json.loads((ROOT / "configs" / "qwen3_0p6b.json").read_text())
    port = lm.port_config(cfg)
    assert port.padded_vocab == lm.padded(cfg["vocab_size"]) == 153_600
    for key, field in lm.FIELDS.items():
        assert getattr(port, field) == cfg[key], key
    assert port.norm_eps == 1e-6 and lm.dtype(cfg) == torch.bfloat16


def _config(**change):
    cfg = json.loads((ROOT / "configs" / "qwen3_0p6b.json").read_text())
    return {**cfg, **change}


@pytest.mark.parametrize("change", [
    {"sliding_window": 4096}, {"tie_word_embeddings": True},
    {"hidden_act": "gelu"}])
def test_configuration_the_port_cannot_run_is_refused(change):
    with pytest.raises(ValueError):
        lm.port_config(_config(**change))


@pytest.mark.parametrize("cell,change", [
    ("qwen3_0p6b.train", {"dropout": 0.1}),
    ("qwen3_0p6b.train", {"optimizer": {"name": "lion", "lr": 1e-3}}),
    ("qwen3_0p6b.prefill", {"temperature": 0.7}),
    ("qwen3_0p6b.prefill", {"generator": "lm_train"})])
def test_mix_the_driver_does_not_read_is_refused(cell, change):
    spec, cfg, traffic, driver = _files(cell)
    with pytest.raises(ValueError):
        driver.Bench(cfg, {**traffic, **change}, spec, SEED, "cpu", TINY)


def test_torch_dtype_reaches_the_port_and_the_reference():
    spec, cfg, traffic, driver = _files("qwen3_0p6b.train")
    bench = driver.Bench(_config(torch_dtype="float32"), traffic, spec, SEED,
                         "cpu", TINY)
    assert bench.port.dtype == "float32"
    seen = {}
    real = ref.train

    def train(*a, **k):
        seen.update(k)
        return real(*a, **k)
    bench.traffic["check_steps"] = 1
    import unittest.mock
    with unittest.mock.patch.object(ref, "train", train):
        bench.reference()
    assert seen["store_dtype"] == torch.float32


def test_weights_are_seeded_and_shaped_as_the_port_holds_them():
    cfg = lm.sized(json.loads(
        (ROOT / "configs" / "qwen3_0p6b.json").read_text()), TINY)
    a = data.lm_weights(cfg, 2048, SEED, "cpu")
    b = data.lm_weights(cfg, 2048, SEED, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    model = lm.load_model(lm.port_config(cfg), a, "cpu")
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == \
        {n: tuple(t.shape) for n, t in a.items()}
    assert float(a["layers.0.ln1"].min()) == 1.0


@pytest.mark.parametrize("cell", ["qwen3_0p6b.train", "qwen3_0p6b.prefill"])
@pytest.mark.parametrize("trace", [False, True])
def test_cell_is_correct_on_the_cpu(cell, trace):
    out = _run(cell, trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0
    if not trace:
        assert "setup_s" in out["metrics"] and len(out["metrics"]) == 2


def test_reference_matches_the_ports_float32_forward():
    """The reference and the port agree in float32 to rounding: the same
    architecture, written twice."""
    from repro_torch.models import build

    cfg = lm.sized(json.loads(
        (ROOT / "configs" / "qwen3_0p6b.json").read_text()),
        {**TINY, "torch_dtype": "float32"})
    w = data.lm_weights(cfg, 2048, SEED, "cpu", dtype=torch.float32)
    port = lm.port_config(cfg)
    model = lm.load_model(port, w, "cpu")
    tokens = data.token_ids(cfg["vocab_size"], (2, 32), SEED, 0, "cpu")
    got, _ = build(port, device="cpu").prefill(model, {"tokens": tokens})
    want = ref.last_logits(w, tokens, cfg)
    assert torch.allclose(got.float(), want, atol=1e-4 * float(want.abs().max()))


def _limits(cell):
    return json.loads((ROOT / "cells" / f"{cell}.json").read_text())["limits"]


def test_training_control_and_half_batch_fail_a_limit():
    spec, cfg, traffic, driver = _files("qwen3_0p6b.train")
    rows = control.train_readings(spec, cfg, traffic, driver, SEED, True,
                                  device="cpu", overrides=TINY)
    limits = _limits("qwen3_0p6b.train")
    by = {r["kind"]: r for r in rows}
    assert all(by["program"][k] <= limits[k] for k in limits)
    for kind in ("control_fp8", "fault_half_batch"):
        assert any(by[kind][k] > limits[k] for k in limits), by[kind]


def test_training_step_that_leaves_the_state_unchanged_fails(monkeypatch):
    import dataclasses

    import repro_torch.optim as optim

    real = optim.adamw
    monkeypatch.setattr(optim, "adamw", lambda *a, **k: dataclasses.replace(
        real(*a, **k), update=lambda grads, state, params, step:
        (params, state)))
    out = _run("qwen3_0p6b.train")
    assert not out["correct"]
    assert out["checks"]["update_gap"]["value"] == pytest.approx(1.0)


def test_prefill_control_and_faults_fail_the_limit(monkeypatch):
    spec, cfg, traffic, driver = _files("qwen3_0p6b.prefill")
    rows = control.prefill_readings(spec, cfg, traffic, driver, SEED, True,
                                    device="cpu", overrides=TINY)
    limit = _limits("qwen3_0p6b.prefill")["logit_gap"]
    by = {r["kind"]: r["logit_gap"] for r in rows}
    assert by["program"] <= limit
    assert by["fault_altered"] > limit and by["fault_half_batch"] > limit


def test_prefill_with_altered_ids_is_not_correct(monkeypatch):
    import repro_torch.serve as serve

    real = serve.generate
    monkeypatch.setattr(serve, "generate",
                        lambda *a, **k: (real(*a, **k) + 1) % 512)
    out = _run("qwen3_0p6b.prefill")
    assert not out["correct"]
