"""Hand-written Hopper kernels and their wrappers.

word_logical   — word-aligned AND/OR/XOR/ANDNOT with clean-tile skipping
                 (``csrc/word_logical.cu``), the executor's dense path
grad_compress  — per-block squared gradient norms
                 (``csrc/grad_compress.cu``) and the keep mask of the EWAH
                 gradient exchange
popcount       — total and per-row set bits of word matrices
                 (``csrc/popcount.cu``)
bitpack_kernel — (rows x bitmaps) bools packed into 32-bit words
                 (``csrc/bitpack.cu``)
``ops`` holds the padding glue, ``logical_reduce`` and the public entry
points of every kernel.  CUDA sources build with ``nvcc`` at first use
(``_build``); nothing builds at import.
"""
from . import bitpack_kernel, grad_compress, ops, popcount, word_logical

__all__ = ["bitpack_kernel", "grad_compress", "ops", "popcount",
           "word_logical"]
