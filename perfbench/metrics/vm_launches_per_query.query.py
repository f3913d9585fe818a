"""VM launches a query: every launch passes `core/lowering.py`
`VmCall.run`, which counts `vm_launches_total` (one a plan group, one a
shared CSE plane). Over every batch the run served
(`perfbench/program_counters.py`). Moves ``queries_per_s``."""
from perfbench import program_counters


def read(ctx):
    return program_counters.per_query(ctx, "vm_launches_total", 1.0)
