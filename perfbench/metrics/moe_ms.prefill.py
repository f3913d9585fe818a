"""MoE layers (`models/moe.py` `moe_ffn`): device milliseconds a request
in the program's ``moe.route``, ``moe.experts`` and ``moe.shared`` spans
over the profiled stretch (CUDA events at the spans' edges,
`obs.device`). Moves ``prefill_tokens_per_s``."""

SPANS = ("moe.route", "moe.experts", "moe.shared")


def read(ctx):
    st = ctx.stretch
    if not st:
        return None
    spans, n = st.get("spans") or {}, st["counters"].get("requests")
    if "moe.experts" not in spans or not n:
        return None
    return sum(spans.get(s, 0.0) for s in SPANS) * 1e3 / n
