"""Bulk bitwise operations on packed words — the deployable fast path."""
from repro_torch.ops.bitwise import (andnot, bitwise_and, bitwise_nand,
                                     bitwise_nor, bitwise_not, bitwise_or,
                                     bitwise_xnor, bitwise_xor, majority3)
from repro_torch.ops.popcount import popcount_u32, popcount_words
from repro_torch.ops.predicate import (VerticalColumn, between_scan,
                                       range_scan_expr, scan_count)
from repro_torch.ops.setops import BitSet
from repro_torch.ops.transpose import to_vertical

__all__ = ["andnot", "bitwise_and", "bitwise_nand", "bitwise_nor",
           "bitwise_not", "bitwise_or", "bitwise_xnor", "bitwise_xor",
           "majority3", "popcount_u32", "popcount_words", "VerticalColumn",
           "between_scan", "range_scan_expr", "scan_count", "BitSet",
           "to_vertical"]
