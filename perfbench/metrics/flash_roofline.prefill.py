"""Flash kernels (`kernels/flashattn.py` -> `csrc/flashattn.cu`): the
attention products' forward FLOPs of the profiled requests (2 L H d_head
S per prompt token, the causal half) over the bf16 peak, as a share of
the device time of the kernels named below. Moves
``prefill_tokens_per_s``."""

from perfbench.devtrace import seconds_matching

#: the port's flash kernels by name: the Hopper forward, the first
#: design's forward, the float32 path's pre-pass
KERNELS = ("flash_fwd_", "flash_mma_kernel", "tf32_split_kernel")


def read(ctx):
    st = ctx.stretch
    if not ctx.peaks or not st:
        return None
    t = seconds_matching(st["kernels"], KERNELS)
    if t <= 0 or not st["counters"].get("attention_flops"):
        return None
    return st["counters"]["attention_flops"] / ctx.peaks["bf16_flops"] / t * 100
