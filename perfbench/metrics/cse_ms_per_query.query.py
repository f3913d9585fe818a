"""CSE pass: host milliseconds a query in the scheduler's cross-query
sharing pass (`service/scheduler.py` `_apply_cse` ->
`service/optimizer.py` `plan_group_cse`), the program's `cse_pass` span
as its `cse_pass_seconds_total`. Over every batch the run served
(`perfbench/program_counters.py`). Moves ``queries_per_s``."""
from perfbench import program_counters


def read(ctx):
    return program_counters.per_query(ctx, "cse_pass_seconds_total", 1e3)
