"""Plain PyTorch references that decide ``correct``. They import nothing
of the port (`repro_torch`) and take nothing the program made: only the
inputs the benchmark drew from the seed."""
