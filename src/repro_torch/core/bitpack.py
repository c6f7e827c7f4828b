"""Bit packing: boolean vectors <-> 32-bit word arrays (little-endian bits).

Bit ``i`` of word ``w`` corresponds to row ``32*w + i`` — the convention used
throughout the codec, the Pallas kernels and the reference oracles.
"""
from __future__ import annotations

import numpy as np

WORD_BITS = 32


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """Pack a 1-D bool array into uint32 words (pad with zeros)."""
    bits = np.asarray(bits, dtype=bool)
    n = len(bits)
    n_words = -(-n // WORD_BITS)
    if n_words * WORD_BITS != n:
        bits = np.concatenate([bits, np.zeros(n_words * WORD_BITS - n, dtype=bool)])
    by = np.packbits(bits, bitorder="little")
    return by.view("<u4").astype(np.uint32)


def unpack_bits(words: np.ndarray, n_bits: int) -> np.ndarray:
    """Unpack uint32 words into a bool array of length n_bits."""
    words = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
    by = words.astype("<u4").view(np.uint8)
    bits = np.unpackbits(by, bitorder="little")
    return bits[:n_bits].astype(bool)


def pack_matrix(bits: np.ndarray) -> np.ndarray:
    """Pack (n_rows, n_cols) bools column-wise: -> (n_cols, n_words) uint32.

    Column j becomes the packed bitmap of bitmap j (rows = bit positions).
    """
    bits = np.asarray(bits, dtype=bool)
    n, L = bits.shape
    n_words = -(-n // WORD_BITS)
    if n_words * WORD_BITS != n:
        pad = np.zeros((n_words * WORD_BITS - n, L), dtype=bool)
        bits = np.concatenate([bits, pad], axis=0)
    by = np.ascontiguousarray(np.packbits(bits.T, axis=1, bitorder="little"))
    return by.reshape(L, -1).view("<u4").astype(np.uint32).reshape(L, n_words)
