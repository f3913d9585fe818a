"""BitWeaving-V column scans (paper §8.2).

'select count(*) from T where c1 <= val <= c2' over a b-bit column of r rows.
Functional path: the vertical layout (bit-transpose kernel), the fused
scan kernel (`ops.predicate`) and the popcount kernel on the card, their
plain versions on the CPU. Cost model: baseline SIMD BitWeaving streams
all b planes through the cache hierarchy; Buddy executes the per-plane
bitwise update ops in DRAM. Bitcount runs on the CPU for both (streaming
popcount).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.apps.cost import DEFAULT_APP_SYSTEM, AppSystem
from repro_torch.ops.predicate import VerticalColumn


def scan_query(values, n_bits: int, c1: int, c2: int, device=None):
    """Functional count(*) via the fused kernel; returns (count, bitvector).

    A tensor column stays on its device; host values go to ``device``
    (default ``"cuda"``). The count is a 0-dim int64 tensor."""
    from repro_torch.kernels import ops as kops

    col = VerticalColumn.encode(values, n_bits, device=device)
    bv = col.scan(c1, c2)
    return kops.popcount(bv.words), bv


def buddy_ops_per_plane(c1: int, c2: int, n_bits: int) -> int:
    """Exact bulk-op count of the BitWeaving-V predicate update per plane.

    Per constant c, bit j: c_j = 1 -> 2 ops (andnot + or into lt; and into
    eq), c_j = 0 -> 1 op (andnot into eq). Summed over both constants.
    """
    total = 0
    for c in (c1, c2):
        for j in range(n_bits):
            total += 2 if (c >> j) & 1 else 1
    return total


def scan_time_ns(r_rows: int, n_bits: int, c1: int, c2: int, use_buddy: bool,
                 sys: AppSystem = DEFAULT_APP_SYSTEM) -> float:
    plane_bytes = r_rows / 8
    ws = plane_bytes * n_bits
    cache_resident = ws <= sys.l2_bytes
    if use_buddy:
        n_ops = buddy_ops_per_plane(c1, c2, n_bits)
        # independent row-slices spread over banks; ops within the scan are
        # a dependent chain per plane but planes pipeline -> row-parallel
        t_scan = n_ops * sys.buddy_op_ns("and", r_rows, dependent=False)
    else:
        # SIMD predicate evaluation is a single streaming pass over planes
        # (compute overlaps memory); cache-resident when it fits in L2.
        t_scan = sys.cpu_stream_ns(ws, cache_resident)
    # count(*) popcount over the result bitvector (CPU, streaming)
    t_cnt = sys.cpu_bitcount_ns(r_rows, streaming=True,
                                cache_resident=cache_resident)
    return t_scan + t_cnt


def speedup(r_rows: int, n_bits: int, c1: int | None = None,
            c2: int | None = None,
            sys: AppSystem = DEFAULT_APP_SYSTEM) -> float:
    if c1 is None:
        c1 = (1 << n_bits) // 4
    if c2 is None:
        c2 = 3 * (1 << n_bits) // 4
    return scan_time_ns(r_rows, n_bits, c1, c2, False, sys) / \
        scan_time_ns(r_rows, n_bits, c1, c2, True, sys)


def speedup_grid(sys: AppSystem = DEFAULT_APP_SYSTEM) -> Dict:
    """Fig. 11 grid: b x r."""
    out = {}
    for b in (1, 2, 4, 8, 12, 16, 20, 24, 28, 32):
        for r in (1 << 20, 1 << 23, 1 << 25):
            out[(b, r)] = speedup(r, b, sys=sys)
    return out
