"""Synthetic fact-table generators matching the paper's §4.1.

* uniform tables: dim i draws uniformly from 100 * r^i distinct values
  (r in {1, 2}); optional *dependent* attributes a_dep = sum(a_i * p_i) with
  p_i ~ Bernoulli(0.2) (uniform in 1..100 when all p_i = 0); columns are
  randomly permuted afterwards, as in the paper.
* Zipf tables with skew s in {0.5, 1.0, 1.5, 2.0}.
* ``factorize`` maps raw values to alphabetical (numerical) ranks, the
  convention the index builder expects.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def factorize(table: np.ndarray) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Per-column value -> rank (sorted order).  Returns (ranked, uniques)."""
    table = np.asarray(table)
    out = np.empty_like(table, dtype=np.int64)
    uniques = []
    for c in range(table.shape[1]):
        u, inv = np.unique(table[:, c], return_inverse=True)
        out[:, c] = inv
        uniques.append(u)
    return out, uniques


def uniform_table(
    n: int,
    d_indep: int,
    r: int = 1,
    n_dep: int = 0,
    rng: Optional[np.random.Generator] = None,
    base_card: int = 100,
    permute_columns: bool = True,
) -> np.ndarray:
    """Uniform synthetic data of §4.1 (d_indep independent + n_dep dependent)."""
    rng = rng or np.random.default_rng(0)
    cols = []
    for i in range(d_indep):
        card = base_card * (r ** i)
        cols.append(rng.integers(0, card, size=n))
    indep = np.stack(cols, axis=1) if cols else np.zeros((n, 0), dtype=np.int64)
    dep_cols = []
    for _ in range(n_dep):
        p = rng.random(d_indep) < 0.2
        if p.any():
            vals = (indep * p[None, :]).sum(axis=1)
        else:
            vals = rng.integers(1, base_card + 1, size=n)
        dep_cols.append(vals)
    table = np.concatenate(
        [indep] + ([np.stack(dep_cols, axis=1)] if dep_cols else []), axis=1
    )
    if permute_columns and table.shape[1] > 1:
        table = table[:, rng.permutation(table.shape[1])]
    return table.astype(np.int64)


def zipf_table(
    n: int,
    d: int,
    s: float = 1.0,
    card: int = 2000,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Zipf-distributed columns: P(v = i) ∝ 1 / i^s over i in 1..card."""
    rng = rng or np.random.default_rng(0)
    ranks = np.arange(1, card + 1, dtype=np.float64)
    p = ranks ** (-s)
    p /= p.sum()
    cols = [rng.choice(card, size=n, p=p) for _ in range(d)]
    return np.stack(cols, axis=1).astype(np.int64)


def census_like_table(n: int = 20000, rng: Optional[np.random.Generator] = None
                      ) -> np.ndarray:
    """A Census-Income-shaped table: 3 dims with cards ~ (91, 1240, ~n/2),
    the last one skewed with a dominant value (as in Census-Income B)."""
    rng = rng or np.random.default_rng(7)
    d1 = rng.integers(0, 91, size=n)
    d2 = (rng.pareto(1.5, size=n) * 50).astype(np.int64) % 1240
    d3 = np.where(rng.random(n) < 0.3,
                  0, rng.integers(0, max(n // 2, 2), size=n))
    return np.stack([d1, d2, d3], axis=1).astype(np.int64)
