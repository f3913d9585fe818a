"""Planner: host milliseconds a query spends in the program's ``plan``
spans (`service/planner.py`, `Planner.plan`), over the profiled stretch.
Moves ``queries_per_s``."""


def read(ctx):
    st = ctx.stretch
    if not st or not st["counters"].get("queries") or "plan" not in st["spans"]:
        return None
    return st["spans"]["plan"] / st["counters"]["queries"] * 1e3
