"""The benchmark of the PyTorch and CUDA port (`repro_torch`).

One command runs one cell (a configuration under a traffic mix, as
`BENCHMARK.json` names it) on the card and prints one JSON line:

    python perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<mix>.json``, ``cells/<cell>.json``
(the cell's driver and correctness limits), ``metrics/<metric>.py`` (one
reader each) and ``drivers/<driver>.py`` (one per kind of work: the
query engine, LM training, LM prefill). ``reference/`` holds the plain
PyTorch references that decide ``correct``; ``counts.py`` the frozen
byte and FLOP counts; ``peaks.py`` the card's published peaks.
"""
