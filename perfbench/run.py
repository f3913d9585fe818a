"""Run one benchmark cell on the card and print its result line.

    python perfbench/run.py --workload ssb_q1.count --seed 7 --seconds 30 \
        --trace 0

Run from the root of a checkout: the port is imported from ``src/``. The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
also ``breakdown``, and last ``checks``: each number compared with its
limit, which also end standard error). With no CUDA card, or fewer cards
than the cell asks for, it prints no result and exits 2.
"""
import time

T0 = time.perf_counter()   # the run's set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


def _prepare_environment() -> None:
    """Keep every kernel cache inside the checkout, at fixed paths, and
    the host's math libraries on one thread each: the program's host work
    is a single Python thread, and idle pool threads only add jitter."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    build = CHECKOUT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(CHECKOUT / "src"), str(CHECKOUT)]


if __name__ == "__main__":
    _prepare_environment()
    from perfbench import harness

    sys.exit(harness.main(sys.argv[1:], T0))
