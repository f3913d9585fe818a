"""VM and copies (`kernels/vm.py` -> `csrc/vm.cu`): the bytes the
stretch's queries must move (`counts.query_bytes`) over the card's HBM
bandwidth, as a share of the device's busy time in the stretch. Moves
``queries_per_s``."""


def read(ctx):
    st = ctx.stretch
    if not ctx.peaks or not st or st["busy_s"] <= 0 \
            or not st["counters"].get("bytes"):
        return None
    bound_s = st["counters"]["bytes"] / ctx.peaks["hbm_bytes_per_s"]
    return bound_s / st["busy_s"] * 100
