"""Hand-written Hopper kernels and their wrappers.

word_logical  — word-aligned AND/OR/XOR/ANDNOT with clean-tile skipping
                (``csrc/word_logical.cu``), the executor's dense path
grad_compress — per-block squared gradient norms (``csrc/grad_compress.cu``)
                and the keep mask of the EWAH gradient exchange
``ops`` holds the padding glue and ``logical_reduce``.  CUDA sources build
with ``nvcc`` at first use (``_build``); nothing builds at import.
"""
from . import grad_compress, ops, word_logical

__all__ = ["grad_compress", "ops", "word_logical"]
