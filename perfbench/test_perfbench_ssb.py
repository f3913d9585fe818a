"""The SSB cells on the CPU at a few thousand rows: the generator, the
traffic's day codes, the port's query service against the plain
reference, the control and the planted faults all decide ``correct`` as
on the card."""
import datetime
import json
import time
from pathlib import Path

import pytest
import torch

from perfbench import data, harness
from perfbench.reference import ssb as ref

ROOT = Path(__file__).resolve().parent
CONFIG = json.loads((ROOT / "configs" / "ssb_sf10.json").read_text())
ROWS = 1 << 14
SMALL = {"rows": ROWS}
SEED = 2**31 + 11


def _day(y, m, d):
    return (datetime.date(y, m, d) - datetime.date(1992, 1, 1)).days


def _codes(seed):
    return {c["name"]: v for c, v in data.ssb_columns(CONFIG, ROWS, seed,
                                                       "cpu")}


def test_generator_is_deterministic_and_seeded():
    a, b, c = _codes(SEED), _codes(SEED), _codes(SEED + 1)
    for col in CONFIG["columns"]:
        n = col["name"]
        assert torch.equal(a[n], b[n]) and not torch.equal(a[n], c[n])
        assert int(a[n].min()) >= col["min"] and int(a[n].max()) <= col["max"]


@pytest.mark.parametrize("mix", ["flight1_count", "flight1_select"])
def test_flight1_day_codes(mix):
    shapes = json.loads((ROOT / "traffic" / f"{mix}.json").read_text())[
        "shapes"]
    dates = [s["ranges"]["lo_orderdate"] for s in shapes]
    assert dates[0] == [[_day(y, 1, 1), _day(y, 12, 31)]
                        for y in range(1992, 1999)]
    assert dates[1][0] == [_day(1994, 1, 1), _day(1994, 1, 31)]
    assert dates[1][11] == [_day(1994, 12, 1), _day(1994, 12, 31)]
    assert len(dates[2]) == 52 and dates[2][5] == [_day(1994, 2, 5),
                                                   _day(1994, 2, 11)]
    assert _day(1998, 12, 31) == CONFIG["columns"][0]["max"]


def test_reference_pack_is_lsb_first():
    bits = torch.zeros(64, dtype=torch.bool)
    bits[[0, 31, 33]] = True
    assert ref.pack(bits).tolist() == [1 - 2**31, 2]


def _run(cell, seconds=1.5, trace=False, **over):
    return harness.run_cell(cell, SEED, seconds, trace, time.perf_counter(),
                            device="cpu", overrides={**SMALL, **over})


@pytest.mark.parametrize("cell", ["ssb_q1.count", "ssb_q1.select"])
@pytest.mark.parametrize("trace", [False, True])
def test_cell_is_correct_on_the_cpu(cell, trace):
    out = _run(cell, trace=trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    kind = "per_layer" if trace else "end_to_end"
    listed = {m["name"] for m in harness.metrics_of(
        harness.load_manifest(), cell, kind)}
    if trace:      # the card's metrics are left out on the CPU
        assert "plan_groups_per_query.query" in out["metrics"]
        assert out["metrics"]["latency_p95_ms.query"]["value"] > 0
        assert set(out["metrics"]) <= listed
    else:
        assert set(out["metrics"]) == listed


@pytest.mark.parametrize("cell", ["ssb_q1.count", "ssb_q1.select"])
def test_control_is_not_correct(cell):
    out = _run(cell, control=True)
    assert not out["correct"]
    assert out["checks"]["wrong_counts"]["value"] > 0


def _stale(monkeypatch):
    """Each batch answered with the previous batch's results."""
    from repro_torch.service.service import QueryService

    real, seen = QueryService.query_batch, []

    def stale(self, queries):
        report = real(self, queries)
        if seen:
            report.results, seen[0] = seen[0], report.results
        else:
            seen.append(report.results)
        return report
    monkeypatch.setattr(QueryService, "query_batch", stale)


def _half(monkeypatch):
    """Each query run over the first half of the rows, a count doubled."""
    from repro_torch.service import scheduler

    real = scheduler.lowering.execute_lowered

    def lowered(program, operands, *args, **kw):
        half = {}
        for name, rows in operands.items():
            rows = [r.clone() for r in rows]
            for r in rows:
                r[..., r.shape[-1] // 2:] = 0
            half[name] = rows
        out = real(program, half, *args, **kw)
        if kw.get("reduce") == "popcount":
            out = {k: 2 * v for k, v in out.items()}
        return out
    monkeypatch.setattr(scheduler.lowering, "execute_lowered", lowered)


def _plus_one(monkeypatch):
    """Each answer altered where it is produced: one more row counted,
    and the first word of each selection flipped."""
    from repro_torch.service import scheduler

    real = scheduler._weighted
    monkeypatch.setattr(scheduler, "_weighted", lambda counts, n:
                        [x + 1 for x in real(counts, n)])
    real_words = scheduler.to_uint32

    def flipped(words):
        out = real_words(words).copy()
        out[..., 0] ^= 1
        return out
    monkeypatch.setattr(scheduler, "to_uint32", flipped)


@pytest.mark.parametrize("fault", [_stale, _half, _plus_one])
@pytest.mark.parametrize("cell", ["ssb_q1.count", "ssb_q1.select"])
def test_planted_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(cell)
    assert not out["correct"], (fault.__name__, out["checks"])


def _query_files(cell):
    spec = harness.cell_spec(harness.load_manifest(), cell)
    return (spec, harness.load_json(ROOT / "traffic" / f"{spec['traffic']}.json"),
            harness.load_module(ROOT / "drivers" / "query.py"))


@pytest.mark.parametrize("where,change", [
    ("config", {"partitions": 4}),
    ("column", {"distribution": "zipf"}),
    ("traffic", {"clients": 4}),
    ("traffic", {"mode": "aggregate"}),
    ("shape", {"weights": [1, 2]})])
def test_file_the_driver_does_not_read_is_refused(where, change):
    spec, traffic, driver = _query_files("ssb_q1.count")
    config = json.loads(json.dumps(CONFIG))
    traffic = json.loads(json.dumps(traffic))
    if where == "config":
        config.update(change)
    elif where == "column":
        config["columns"][0].update(change)
    elif where == "traffic":
        traffic.update(change)
    else:
        traffic["shapes"][0].update(change)
    with pytest.raises(ValueError):
        driver.Bench(config, traffic, spec, SEED, "cpu", SMALL)


@pytest.mark.parametrize("service,error", [
    ({"n_banks": 8, "replicas": 2}, TypeError),
    ({"n_banks": 8, "timing": {"tRCD": 11}}, ValueError),
    ({"n_banks": 8, "reliability": {"mode": "vote", "k": 2}}, ValueError)])
def test_service_the_port_does_not_know_is_refused(service, error):
    spec, traffic, driver = _query_files("ssb_q1.count")
    bench = driver.Bench({**CONFIG, "service": service}, traffic, spec, SEED,
                         "cpu", SMALL)
    with pytest.raises(error):
        bench.setup()


def test_service_is_the_configurations_whole():
    _, _, driver = _query_files("ssb_q1.count")
    cfg = driver.service_config(
        {**CONFIG["service"], "reliability": {"mode": "vote", "k": 3}},
        "cpu", None)
    assert cfg.n_banks == 8 and cfg.optimize and cfg.plan_cache_capacity == 1024
    assert cfg.reliability.mode == "vote" and cfg.reliability.k == 3
