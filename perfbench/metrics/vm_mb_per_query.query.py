"""VM traffic: megabytes a query that the VM's launches read and write by
the program's own count (`vm_bytes_total`: the stacked operand plane,
plus the output rows or, under the fused popcount, the counts). Over
every batch the run served (`perfbench/program_counters.py`). Moves
``queries_per_s``."""
from perfbench import program_counters


def read(ctx):
    return program_counters.per_query(ctx, "vm_bytes_total", 1e-6)
