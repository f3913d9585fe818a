"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version in the same module. A wrapper launches its kernel for CUDA
tensors and runs the plain version for CPU tensors; it never falls back
from one to the other."""
import collections

#: launches per kernel name; each wrapper adds one right where it launches
#: its kernel and nowhere else (the plain path never counts)
LAUNCHES: "collections.Counter[str]" = collections.Counter()
