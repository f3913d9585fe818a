"""Device: the share of the profiled stretch of the prefill cell in which
no kernel, copy or memset ran. Moves ``prefill_tokens_per_s``."""


def read(ctx):
    st = ctx.stretch
    if not st or st["busy_s"] <= 0 or st["window_s"] <= 0:
        return None
    return (1 - st["busy_s"] / st["window_s"]) * 100
