"""Bulk bitwise operations on packed words — the deployable fast path."""
from repro_torch.ops.arith import (add_columns, add_columns_dram,
                                   lt_columns, lt_columns_dram, lt_const,
                                   lt_const_dram, sub_columns,
                                   sub_columns_dram, sum_column,
                                   sum_column_dram)
from repro_torch.ops.bloom import BloomFilter
from repro_torch.ops.bitwise import (andnot, bitwise_and, bitwise_nand,
                                     bitwise_nor, bitwise_not, bitwise_or,
                                     bitwise_xnor, bitwise_xor, majority3)
from repro_torch.ops.crypto import keystream, xor_decrypt, xor_encrypt
from repro_torch.ops.masked_init import (field_mask, masked_fill_constant,
                                         masked_init)
from repro_torch.ops.popcount import popcount_u32, popcount_words
from repro_torch.ops.predicate import (VerticalColumn, between_scan,
                                       range_scan_expr, scan_count)
from repro_torch.ops.setops import BitSet
from repro_torch.ops.transpose import from_vertical, to_vertical

__all__ = ["andnot", "bitwise_and", "bitwise_nand", "bitwise_nor",
           "bitwise_not", "bitwise_or", "bitwise_xnor", "bitwise_xor",
           "majority3", "popcount_u32", "popcount_words", "VerticalColumn",
           "between_scan", "range_scan_expr", "scan_count", "BitSet",
           "to_vertical", "from_vertical", "add_columns", "sub_columns",
           "lt_columns", "lt_const", "sum_column", "add_columns_dram",
           "sub_columns_dram", "lt_columns_dram", "lt_const_dram",
           "sum_column_dram", "masked_init", "masked_fill_constant",
           "field_mask", "BloomFilter", "xor_encrypt", "xor_decrypt",
           "keystream"]
