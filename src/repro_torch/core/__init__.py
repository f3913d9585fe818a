from repro_torch.core.bitplane import (BitVector, as_words, n_words,
                                       pack_bits, to_uint32, unpack_bits)
from repro_torch.core.commands import AAP, AP, Program
from repro_torch.core.compiler import (Expr, compile_expr,
                                       compile_expr_fused, maj)
from repro_torch.core.energy import (DEFAULT_ENERGY, EnergyModel,
                                     program_energy_nj)
from repro_torch.core.engine import Subarray, execute
from repro_torch.core.errors import (ReliabilityConfig, TRAErrorModel,
                                     error_planes, execute_ecc,
                                     execute_injected, execute_voted,
                                     single_fault_planes, vote_outputs)
from repro_torch.core.isa import BopResult, BuddyDevice
from repro_torch.core.timing import (DDR3_1600, DramTiming,
                                     program_latency_ns)

__all__ = ["BitVector", "as_words", "n_words", "pack_bits", "to_uint32",
           "unpack_bits", "AAP", "AP", "Program", "Expr", "compile_expr",
           "compile_expr_fused", "maj", "DEFAULT_ENERGY", "EnergyModel",
           "program_energy_nj", "Subarray", "execute", "DDR3_1600",
           "DramTiming", "program_latency_ns", "TRAErrorModel",
           "ReliabilityConfig", "error_planes", "single_fault_planes",
           "execute_injected", "execute_voted", "execute_ecc",
           "vote_outputs", "BuddyDevice", "BopResult"]
