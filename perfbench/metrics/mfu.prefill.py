"""Serve step (`serve/step.py::generate`): the prefill FLOPs of the
untraced window's requests (`counts.prefill_flops`: 2 N per prompt
token, the head once per sequence, the causal attention products) over
(its wall x the card's bf16 peak). Moves ``prefill_tokens_per_s``."""


def read(ctx):
    pre = ctx.pre
    if not ctx.peaks or pre["seconds"] <= 0 or not pre["counters"].get("flops"):
        return None
    return (pre["counters"]["flops"]
            / (pre["seconds"] * ctx.peaks["bf16_flops"]) * 100)
