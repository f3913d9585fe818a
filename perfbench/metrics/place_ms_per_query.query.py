"""Modeled placement: host milliseconds a query in the scheduler's modeled
DRAM timeline (`service/scheduler.py` `_place_batch`), the program's
`place` span as its `place_seconds_total`. Over every batch the run
served (`perfbench/program_counters.py`). Moves ``queries_per_s``."""
from perfbench import program_counters


def read(ctx):
    return program_counters.per_query(ctx, "place_seconds_total", 1e3)
