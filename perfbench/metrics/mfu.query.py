"""The whole batch path's share of the card's binding peak, which for
bitwise work is HBM bandwidth: the bytes the window's queries must move
(`counts.query_bytes`) over (the untraced window's wall x 3.35 TB/s).
Moves ``queries_per_s``."""


def read(ctx):
    pre = ctx.pre
    if not ctx.peaks or pre["seconds"] <= 0 or not pre["counters"].get("bytes"):
        return None
    return (pre["counters"]["bytes"]
            / (pre["seconds"] * ctx.peaks["hbm_bytes_per_s"]) * 100)
