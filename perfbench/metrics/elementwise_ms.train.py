"""Optimizer and elementwise passes (`optim/optimizers.py`, the norms,
the loss): device milliseconds a step in kernels that are neither GEMMs
nor flash kernels (copies and memsets included), over the profiled
steps: chip_smoke's "other" rule. Moves ``train_tokens_per_s``."""

#: the port's flash kernels by name
FLASH = ("flash_fwd_", "flash_bwd_", "flash_mma_kernel", "tf32_split_kernel")


def is_gemm(name: str) -> bool:
    """cuBLAS / CUTLASS GEMMs by name."""
    return ("gemm" in name.lower() or "xmma" in name
            or name.startswith(("nvjet", "cutlass")))


def read(ctx):
    st = ctx.stretch
    if not st or st["busy_s"] <= 0 or not st["counters"].get("steps"):
        return None
    other = sum(s for n, s in st["kernels"].items()
                if not is_gemm(n) and not any(p in n for p in FLASH))
    return other / st["counters"]["steps"] * 1e3
