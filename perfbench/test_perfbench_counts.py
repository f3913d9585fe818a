"""The benchmark's byte and FLOP counts against hand-worked values."""
import json
from pathlib import Path

import pytest

from perfbench import counts

ROOT = Path(__file__).resolve().parent
QWEN = json.loads((ROOT / "configs" / "qwen3_0p6b.json").read_text())


@pytest.mark.parametrize("bits,lo,hi,planes", [
    (4, 1, 3, 4),        # {1, 2, 3}: every plane separates some pair
    (4, 0, 15, 0),       # always true
    (12, 0, 2047, 1),    # the top bit alone
    (12, 2048, 4095, 1),
    (6, 0, 31, 1),
    (6, 0, 24, 6),
    (2, 1, 1, 2),
    (3, 0, 3, 1),
])
def test_planes_needed(bits, lo, hi, planes):
    assert counts.planes_needed(bits, lo, hi) == planes


def test_query_bytes_q1_1():
    bits = {"lo_orderdate": 12, "lo_discount": 4, "lo_quantity": 6}
    r = {"lo_orderdate": (0, 365), "lo_discount": (1, 3),
         "lo_quantity": (0, 24)}
    plane = 60_000_000 // 8
    assert counts.plane_bytes(60_000_000) == plane
    n = counts.planes_needed(12, 0, 365)
    assert counts.query_bytes(60_000_000, bits, r, False) == (n + 10) * plane
    assert counts.query_bytes(60_000_000, bits, r, True) == (n + 11) * plane


def test_qwen3_training_flops_per_token():
    layer = 1024 * 16 * 128 * 2 + 1024 * 8 * 128 * 2 + 3 * 1024 * 3072
    assert layer == 15_728_640
    n = 28 * layer + 1024 * 151_936
    assert n == 595_984_384
    per_token = 6 * n + 6 * 28 * 16 * 128 * 4096
    assert per_token == 4_985_192_448
    f = counts.train_flops(QWEN, 8, 4096)
    assert f["model"] == per_token * 8 * 4096
    assert f["attention"] == 6 * 28 * 16 * 128 * 4096 * 8 * 4096


def test_qwen3_prefill_flops():
    body = 2 * 28 * 15_728_640 * 2048
    head = 2 * 1024 * 151_936
    attention = 2 * 28 * 16 * 128 * 2048 * 2048
    f = counts.prefill_flops(QWEN, [2048] * 8)
    assert f["attention"] == 8 * attention
    assert f["model"] == 8 * (body + head + attention)


@pytest.mark.parametrize("name,known", [
    ("NVIDIA H100 80GB HBM3", True), ("NVIDIA H100 PCIe", False),
    ("NVIDIA H100 NVL", False), ("NVIDIA A100-SXM4-80GB", False)])
def test_peaks_are_those_of_the_named_card_alone(name, known):
    from perfbench import peaks

    got = peaks.for_card(name)
    assert (got is not None) == known
    if known:
        assert got == {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}
