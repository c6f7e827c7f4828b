"""Hand-written Hopper kernels and their wrappers.

logical_reduce — n-ary AND/OR/XOR and AND-NOT of word rows with
                 clean-block skipping, one launch per 128 rows
                 (``csrc/logical_reduce.cu``), the executor's dense path
word_logical   — pairwise AND/OR/XOR/ANDNOT with clean-tile skipping
                 (``csrc/word_logical.cu``), ``ops.word_logical``
grad_compress  — per-block squared gradient norms
                 (``csrc/grad_compress.cu``) and the keep mask of the EWAH
                 gradient exchange
popcount       — total and per-row set bits of word matrices
                 (``csrc/popcount.cu``)
bitpack_kernel — (rows x bitmaps) bools packed into 32-bit words
                 (``csrc/bitpack.cu``)
``ops`` holds the padding glue and the public entry points of every
kernel.  CUDA sources build with ``nvcc`` at first use
(``_build``); nothing builds at import.
"""
from . import (bitpack_kernel, grad_compress, logical_reduce, ops, popcount,
               word_logical)

__all__ = ["bitpack_kernel", "grad_compress", "logical_reduce", "ops",
           "popcount", "word_logical"]
