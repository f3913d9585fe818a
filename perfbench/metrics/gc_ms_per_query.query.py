"""Python's collector: milliseconds a query of collections that ran inside
a batch (`obs`'s `gc.callbacks` hook, `gc_pause_seconds_total` over
every generation); they land inside the spans that
`cse_ms_per_query.query` and `place_ms_per_query.query` read. 0 is a
reading. Over every batch the run served
(`perfbench/program_counters.py`). Moves ``queries_per_s``."""
from perfbench import program_counters


def read(ctx):
    return program_counters.per_query(ctx, "gc_pause_seconds_total", 1e3)
