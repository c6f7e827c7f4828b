"""k-of-N encoding and bitmap-code allocation (paper §2.2, §3.2).

* ``bitmaps_needed(card, k)`` — smallest L with C(L,k) >= card.
* Alphabetic allocation (Algorithm 2): the i-th attribute value (alphabetical
  rank i) receives the i-th k-combination of {0..L-1} in lexicographic order.
  Implemented as vectorized unranking (combinatorial number system).
* Gray allocation: combinations enumerated in revolving-door (Gray) order, so
  consecutive values' codes differ by a single bit swap; matches the paper's
  2-of-4 example 0011, 0110, (0101,) 1100, 1010, 1001.
* ``choose_k`` — the paper's cardinality heuristic (<=5 -> 1-of-N only,
  <=21 -> up to 2-of-N, <=85 -> up to 3-of-N).
"""
from __future__ import annotations

from functools import lru_cache
from math import comb
from typing import List

import numpy as np


def bitmaps_needed(card: int, k: int) -> int:
    """Smallest L >= k with C(L, k) >= card."""
    assert card >= 1 and k >= 1
    if k == 1:
        return card
    L = k
    while comb(L, k) < card:
        L += 1
    return L


def choose_k(card: int, max_k: int) -> int:
    """Paper heuristic capping k by column cardinality."""
    if card <= 5:
        return 1
    if card <= 21:
        return min(max_k, 2)
    if card <= 85:
        return min(max_k, 3)
    return max_k


@lru_cache(maxsize=None)
def _comb_table(n_max: int, k: int) -> np.ndarray:
    """C(x, k) for x in 0..n_max as int64."""
    xs = np.arange(n_max + 1, dtype=np.int64)
    out = np.ones(n_max + 1, dtype=np.int64)
    for i in range(k):
        out = out * (xs - i)
    for i in range(2, k + 1):
        out //= i
    out[xs < k] = 0
    return out


def unrank_lex(ranks: np.ndarray, L: int, k: int) -> np.ndarray:
    """Vectorized lex unranking: rank -> sorted k-tuple of bitmap positions.

    Lexicographic order over sorted tuples (c_0 < c_1 < ... < c_{k-1}) —
    exactly the order Algorithm 2's odometer enumerates.
    """
    ranks = np.asarray(ranks, dtype=np.int64)
    assert ranks.ndim == 1
    out = np.empty((len(ranks), k), dtype=np.int32)
    r = ranks.copy()
    prev = np.full(len(ranks), -1, dtype=np.int64)
    for t in range(k):
        m = k - t
        C = _comb_table(L, m)
        Lp = L - 1 - prev  # remaining alphabet size per row
        total = C[Lp]
        # largest e with C(Lp - e, m) >= total - r  (C decreasing in e)
        target = total - r
        v = np.searchsorted(C, target, side="left")  # smallest v with C[v] >= target
        e = Lp - v
        r = r - (total - C[v])
        pos = prev + 1 + e
        out[:, t] = pos
        prev = pos
    assert np.all(r == 0), "rank out of range"
    return out


def revolving_door(L: int, k: int, limit: int | None = None) -> np.ndarray:
    """Combinations of {0..L-1} choose k in revolving-door Gray order.

    A(n,k) = A(n-1,k) ++ reversed(A(n-1,k-1)) x {n-1}; consecutive sets differ
    by one element swap.  Returns (count, k) int32 array of sorted tuples.
    """
    total = comb(L, k)
    limit = total if limit is None else min(limit, total)

    def gen(n: int, kk: int) -> List[tuple]:
        if kk == 0:
            return [()]
        if kk == n:
            return [tuple(range(n))]
        a = gen(n - 1, kk)
        b = [t + (n - 1,) for t in reversed(gen(n - 1, kk - 1))]
        return a + b

    # generate lazily by increasing n until we have >= limit codes
    # (gen is exact; for limit << total we can still afford full gen when
    #  C(L,k) is the column cardinality bound — always ~card in practice)
    codes = gen(L, k)[:limit]
    return np.array(codes, dtype=np.int32).reshape(limit, k)


class ColumnEncoder:
    """Maps attribute-value ranks (0..card-1) to k bitmap positions.

    ``remap`` is an optional rank permutation (``remap[original] = encoded``)
    — the histogram-aware value reordering of ``repro_torch.core.layout``: frequent
    values get adjacent low encoded ranks so their codes share bitmap
    prefixes and their runs merge.  Applied transparently inside ``codes``;
    every consumer (planner value lowering, builder scatter, equality
    bitmaps) therefore keeps speaking *original* ranks and query results
    never change.  An identity permutation collapses to ``None``.
    """

    def __init__(self, card: int, k: int = 1, allocation: str = "alpha",
                 remap=None):
        assert card >= 1
        self.card = int(card)
        self.k = int(k)
        self.allocation = allocation
        self.L = bitmaps_needed(card, k)
        if remap is not None:
            from .layout import validate_remap
            remap = validate_remap(remap, self.card)
        self.remap = remap
        if allocation == "alpha" or k == 1:
            self._codes = None  # computed on demand via unranking
        elif allocation == "gray":
            self._codes = revolving_door(self.L, self.k, limit=self.card)
        else:
            raise ValueError(f"unknown allocation {allocation!r}")

    def codes(self, value_ranks: np.ndarray) -> np.ndarray:
        """(n,) value ranks -> (n, k) bitmap positions within this column."""
        value_ranks = np.asarray(value_ranks)
        if self.remap is not None:
            value_ranks = self.remap[value_ranks.astype(np.int64)]
        if self.k == 1:
            return value_ranks.reshape(-1, 1).astype(np.int32)
        if self._codes is not None:
            return self._codes[value_ranks]
        return unrank_lex(value_ranks.astype(np.int64), self.L, self.k)

    def all_codes(self) -> np.ndarray:
        """(card, k) codes for every value rank."""
        return self.codes(np.arange(self.card))

    def __repr__(self):
        remap = ", remap" if self.remap is not None else ""
        return (f"ColumnEncoder(card={self.card}, k={self.k}, L={self.L}, "
                f"alloc={self.allocation}{remap})")
