"""Mamba-2 mixers (`models/ssm.py` `ssm_forward`): device milliseconds a
request in the program's ``ssm.mixer`` spans over the profiled stretch
(CUDA events at the spans' edges, `obs.device`). Moves
``prefill_tokens_per_s``."""


def read(ctx):
    st = ctx.stretch
    if not st:
        return None
    spans, n = st.get("spans") or {}, st["counters"].get("requests")
    if "ssm.mixer" not in spans or not n:
        return None
    return spans["ssm.mixer"] * 1e3 / n
