"""Train step (`train/step.py`, `models/transformer.py`): the model FLOPs
of the untraced window's steps (`counts.train_flops`: 6 N per token plus
the causal attention products) over (its wall x the card's bf16 peak).
Moves ``train_tokens_per_s``."""


def read(ctx):
    pre = ctx.pre
    if not ctx.peaks or pre["seconds"] <= 0 or not pre["counters"].get("flops"):
        return None
    return (pre["counters"]["flops"]
            / (pre["seconds"] * ctx.peaks["bf16_flops"]) * 100)
