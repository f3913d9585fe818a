"""The per-layer metrics that read the port's own spans and counters: the
query cells' CPU rehearsal reports them, a program without the counters
gives none, and device work is charged to the innermost program range
open around its launch."""
import time
from types import SimpleNamespace

import pytest

from perfbench import attribution, harness, program_counters

SEED = 2**31 + 23
PROGRAM_METRICS = ("cse_ms_per_query.query", "place_ms_per_query.query",
                   "gc_ms_per_query.query", "vm_launches_per_query.query",
                   "vm_mb_per_query.query")


@pytest.mark.parametrize("cell", ["ssb_q1.count", "ssb_q1.select"])
def test_rehearsal_reports_the_programs_counters(cell):
    out = harness.run_cell(cell, SEED, 1.5, True, time.perf_counter(),
                           device="cpu", overrides={"rows": 1 << 14})
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(PROGRAM_METRICS) <= set(m)
    assert m["cse_ms_per_query.query"] > 0
    assert m["place_ms_per_query.query"] > 0
    assert m["gc_ms_per_query.query"] >= 0
    # one launch a plan group, and one a shared CSE plane
    assert m["vm_launches_per_query.query"] >= \
        m["plan_groups_per_query.query"]
    # each launch reads at least its operand plane: 2^14 rows of 1 bit
    assert m["vm_mb_per_query.query"] >= \
        m["vm_launches_per_query.query"] * (1 << 14) / 8 * 1e-6


def test_no_service_with_the_counters_reads_nothing():
    ctx = SimpleNamespace(traffic={"warmup_batches": 2, "shapes": [0, 1, 2]},
                          pre={"units": 10**9}, stretch={"units": 6})
    assert program_counters.service_counters(ctx) is None
    assert program_counters.per_query(ctx, "vm_launches_total") is None
    assert program_counters.service_counters(
        SimpleNamespace(traffic={}, pre={}, stretch=None)) is None


def _ev(name, id_, device, start, end, annotation=False):
    return SimpleNamespace(
        name=name, id=id_, device_type=device, is_user_annotation=annotation,
        time_range=SimpleNamespace(start=start, end=end))


def test_device_work_is_charged_to_the_innermost_program_range():
    from torch.autograd import DeviceType

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [
        _ev("train_step", 1, cpu, 0, 100, annotation=True),   # a label
        _ev("step.grads", 2, cpu, 1, 40, annotation=True),
        _ev("step.update", 3, cpu, 50, 90, annotation=True),
        _ev("gc", 4, cpu, 60, 70, annotation=True),
        _ev("aten::mul", 5, cpu, 52, 58),
        # launch calls and the device work they launched (same id)
        _ev("cudaLaunchKernel", 7, cpu, 10, 11),
        _ev("cuLaunchKernel", 8, cpu, 55, 56),
        _ev("cudaMemcpyAsync", 9, cpu, 65, 66),
        _ev("cudaLaunchKernel", 10, cpu, 95, 96),
        _ev("cudaLaunchKernel", 11, cpu, 120, 121),
        _ev("gemm", 7, cuda, 20, 30),
        _ev("vm_kernel", 8, cuda, 57, 61),
        _ev("Memcpy DtoD", 9, cuda, 70, 72),
        _ev("mul_kernel", 10, cuda, 97, 98),
        _ev("late_kernel", 11, cuda, 125, 126),
        _ev("orphan_kernel", 12, cuda, 130, 131),    # no launch recorded
        _ev("step.update", 3, cuda, 50, 99, annotation=True),
    ]
    got = attribution.by_span(events, labels=("train_step",))
    assert got == {
        "step.grads": {"device_s": pytest.approx(10e-6), "launches": 1},
        "step.update": {"device_s": pytest.approx(4e-6), "launches": 1},
        "gc": {"device_s": pytest.approx(2e-6), "launches": 1},
        attribution.NO_SPAN: {"device_s": pytest.approx(3e-6),
                              "launches": 3},
    }


def test_a_profile_without_host_activity_charges_no_span():
    from torch.autograd import DeviceType

    events = [_ev("k", 1, DeviceType.CUDA, 0, 5)]
    assert attribution.by_span(events) == {
        attribution.NO_SPAN: {"device_s": pytest.approx(5e-6),
                              "launches": 1}}
