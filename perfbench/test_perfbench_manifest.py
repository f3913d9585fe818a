"""`BENCHMARK.json` against the benchmark's contract, and every file it
names found by name."""
import ast
import json
import re
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
MANIFEST = json.loads((CHECKOUT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert len((CHECKOUT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_command_and_paths():
    cmd, paths = MANIFEST["command"], MANIFEST["paths"]
    assert 1 <= len(cmd) <= 32 and all(LINE.match(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and ".." not in p
        assert (CHECKOUT / p).is_dir()
    for w in cmd:
        assert not w.startswith("/") and ".." not in w
        if w.endswith(".py"):
            assert any(w.startswith(p + "/") for p in paths)


def test_run_seconds_fit_a_full_check_of_24_cells():
    s = MANIFEST["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in MANIFEST[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metric_names_unique_across_kinds():
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    keys = {"name", "unit", "better", "source", "workloads"}
    if metric["name"] == "setup_s":     # every cell reports it
        keys -= {"workloads"}
    if metric in MANIFEST["end_to_end"]:
        keys |= {"bound"}
        assert metric["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        keys |= {"layer", "moves"}
        assert LINE.match(metric["layer"])
    assert set(metric) == keys
    assert UNIT.match(metric["unit"])
    assert metric["better"] in {"lower", "higher"}
    assert metric["source"] in SOURCES
    cells = {w["name"] for w in MANIFEST["workloads"]}
    listed = metric.get("workloads", cells)
    assert listed and set(listed) <= cells


@pytest.mark.parametrize("metric", MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_moves_target_is_reported_by_each_cell(metric):
    target = {m["name"]: m for m in MANIFEST["end_to_end"]}[metric["moves"]]
    assert set(metric["workloads"]) <= set(target["workloads"])


def test_same_layer_same_name():
    layers = {m["layer"] for m in MANIFEST["per_layer"]}
    for a in layers:
        for b in layers:
            assert a == b or a.lower() != b.lower()


@pytest.mark.parametrize("cell", MANIFEST["workloads"],
                         ids=lambda w: w["name"])
def test_cell(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4)
    assert LINE.match(cell["why"])
    assert NAME.match(cell["traffic"])
    assert cell["config"] in {c["name"] for c in MANIFEST["configs"]}
    e2e = harness.metrics_of(MANIFEST, cell["name"], "end_to_end")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert any(cell["name"] in m["workloads"]
               for m in MANIFEST["per_layer"])
    spec = json.loads((ROOT / "cells" / f"{cell['name']}.json").read_text())
    assert (ROOT / "drivers" / f"{spec['driver']}.py").is_file()
    assert (ROOT / "traffic" / f"{cell['traffic']}.json").is_file()
    assert set(spec["limits"]) and all(
        isinstance(v, (int, float)) for v in spec["limits"].values())


def test_pairs_of_config_and_traffic_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_four_chip_cells_within_a_quarter():
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)


@pytest.mark.parametrize("cfg", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert LINE.match(cfg["source"]) and LINE.match(cfg["why"])
    path = CHECKOUT / cfg["file"]
    assert any(cfg["file"].startswith(p + "/") for p in MANIFEST["paths"])
    body = json.loads(path.read_text())
    assert body["name"] == cfg["name"] and body["reduced"] == cfg["reduced"]
    assert len(cfg["reduced"]) <= 16 and all(NAME.match(k)
                                             for k in cfg["reduced"])
    widths = re.compile(r"(hidden|intermediate|latent|state|proj|head|"
                        r"expansion|_dim$|_rank$|experts_per_tok)")
    assert not any(widths.search(k) for k in cfg["reduced"])
    assert any(cfg["name"] == w["config"] for w in MANIFEST["workloads"])
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("metric", MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_each_per_layer_metric_has_a_reader(metric):
    path = ROOT / "metrics" / f"{metric['name']}.py"
    tree = ast.parse(path.read_text())
    assert any(isinstance(n, ast.FunctionDef) and n.name == "read"
               for n in tree.body)


def test_files_under_paths_are_named_from_name_characters():
    for p in ROOT.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(CHECKOUT).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel
