"""Hand-written Hopper kernels and their wrappers.

word_logical — word-aligned AND/OR/XOR/ANDNOT with clean-tile skipping
               (``csrc/word_logical.cu``), the executor's dense path
``ops`` holds the padding glue and ``logical_reduce``.  CUDA sources build
with ``nvcc`` at first use (``_build``); nothing builds at import.
"""
from . import ops, word_logical

__all__ = ["ops", "word_logical"]
