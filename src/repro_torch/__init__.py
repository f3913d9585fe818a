"""PyTorch + CUDA port of the Buddy-RAM bulk-bitwise query engine.

Mirrors the JAX package `repro` module for module at the same relative
paths. Packed words are carried as int32 tensors holding the same bit
patterns as the reference's uint32 words (`core.bitplane.as_words`);
entry points run on the CUDA device unless the caller passes
``device="cpu"``. The kernels on the query path, and the flash attention
of the LM serving path (`models/`, `serve/`), are hand-written CUDA C++
for Hopper (`csrc/`), each with a plain PyTorch version beside it in its
`kernels/` module.
"""
