from repro_torch.ops.popcount import popcount_u32, popcount_words
from repro_torch.ops.predicate import VerticalColumn, range_scan_expr
from repro_torch.ops.transpose import to_vertical

__all__ = ["popcount_u32", "popcount_words", "VerticalColumn",
           "range_scan_expr", "to_vertical"]
