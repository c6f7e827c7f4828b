"""WAH (Word-Aligned Hybrid, Wu et al. 2006) codec — the paper's baseline.

31-bit logical words inside 32-bit physical words:
  * literal word:  MSB = 1, low 31 bits verbatim;
  * fill word:     MSB = 0, bit 30 = fill bit, low 30 bits = run length in
                   31-bit word units (max 2^30 - 1).

Worst case expands by 32/31 (> +3%) as discussed in the paper §2.3.  Used for
size comparisons (WAH vs EWAH); ops go through decode -> op -> encode.
"""
from __future__ import annotations

import numpy as np

LIT_FLAG = np.uint32(1 << 31)
FILL_BIT = np.uint32(1 << 30)
MAX_FILL = (1 << 30) - 1
W = 31  # logical word size


def _to_31bit_words(bits: np.ndarray) -> np.ndarray:
    bits = np.asarray(bits, dtype=bool)
    n = len(bits)
    n_words = -(-n // W) if n else 0
    if n_words * W != n:
        bits = np.concatenate([bits, np.zeros(n_words * W - n, dtype=bool)])
    # big-endian within the 31-bit word is irrelevant for sizes; use little
    weights = (np.uint32(1) << np.arange(W, dtype=np.uint32))
    return (bits.reshape(n_words, W).astype(np.uint32) * weights).sum(axis=1, dtype=np.uint32)


class WAH:
    __slots__ = ("words", "n_bits")

    def __init__(self, words: np.ndarray, n_bits: int):
        self.words = np.asarray(words, dtype=np.uint32)
        self.n_bits = int(n_bits)

    @property
    def size_words(self) -> int:
        return int(len(self.words))

    @classmethod
    def from_bool(cls, bits: np.ndarray) -> "WAH":
        bits = np.asarray(bits, dtype=bool)
        lw = _to_31bit_words(bits)
        all1 = np.uint32((1 << W) - 1)
        out = []
        i, n = 0, len(lw)
        while i < n:
            v = lw[i]
            if v == 0 or v == all1:
                j = i
                while j < n and lw[j] == v and (j - i) < MAX_FILL:
                    j += 1
                fill = FILL_BIT if v == all1 else np.uint32(0)
                out.append(np.uint32(fill | np.uint32(j - i)))
                i = j
            else:
                out.append(np.uint32(LIT_FLAG | v))
                i += 1
        return cls(np.array(out, dtype=np.uint32), len(bits))

    def to_bool(self) -> np.ndarray:
        lw = []
        all1 = np.uint32((1 << W) - 1)
        for w in self.words:
            if w & LIT_FLAG:
                lw.append(np.full(1, w & ~LIT_FLAG, dtype=np.uint32))
            else:
                cnt = int(w & np.uint32(MAX_FILL))
                val = all1 if (w & FILL_BIT) else np.uint32(0)
                lw.append(np.full(cnt, val, dtype=np.uint32))
        lw = np.concatenate(lw) if lw else np.empty(0, np.uint32)
        bits = ((lw[:, None] >> np.arange(W, dtype=np.uint32)) & 1).astype(bool)
        return bits.reshape(-1)[: self.n_bits]
