"""Scheduler: plan groups (one stacked VM dispatch each,
`BatchReport.n_plan_groups`) per query over the untraced part of the
window. Moves ``queries_per_s``."""


def read(ctx):
    c = ctx.pre["counters"]
    if not c.get("queries") or not c.get("plan_groups"):
        return None
    return c["plan_groups"] / c["queries"]
