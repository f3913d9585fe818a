"""Whole batch: the 95th percentile (nearest rank) of the queries'
latencies over the untraced first half of the window, submit to answer
on the host (a query's latency is its batch's wall). The tail lands on
the batches that hold a full pass of Python's collector, so it swings
from run to run with the host; it stands here, with no bound, beside the
rate it should move. Moves ``queries_per_s``."""
import math


def read(ctx):
    lat = sorted(ctx.pre.get("samples", {}).get("query_latency_s", ()))
    if not lat:
        return None
    return lat[max(0, math.ceil(0.95 * len(lat)) - 1)] * 1e3
