"""Query layer over a BitmapIndex: expression API + row-scan oracles.

Queries are composable ``Expr`` trees (see ``repro_torch.core.expr``) built
with operator overloading, planned by ``repro_torch.core.planner`` and
evaluated by ``repro_torch.core.executor``:

    from repro_torch.core import col, query
    hits = query.execute(index, (col(0) == 3) & ~col(1).isin([1, 2]))

The pre-expression free functions (``equality`` / ``conjunction`` /
``disjunction`` / ``in_set``) were deprecated in favor of the expression API
and have been removed now that no caller remains.

``naive_eval`` is the row-scan oracle for arbitrary expressions; the older
``naive_*`` helpers stay for the seed tests.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from .expr import And, Const, Eq, Expr, In, Not, Or, Range, col
from .executor import QueryBatch, execute, execute_rows
from .planner import explain, plan

__all__ = [
    "col", "execute", "execute_rows", "plan", "explain", "QueryBatch",
    "naive_eval", "naive_eval_rows",
    "naive_equality", "naive_conjunction", "naive_disjunction",
]


# -- oracles ---------------------------------------------------------------

def naive_eval(table: np.ndarray, e: Expr,
               names: Optional[Sequence[str]] = None) -> np.ndarray:
    """Row-scan oracle: evaluate an expression to a boolean row mask."""
    table = np.asarray(table)

    def resolve(key) -> int:
        if isinstance(key, (int, np.integer)):
            return int(key)
        assert names is not None, f"column name {key!r} but no names given"
        return list(names).index(key)

    def ev(node: Expr) -> np.ndarray:
        if isinstance(node, Const):
            return np.full(len(table), node.value, dtype=bool)
        if isinstance(node, Eq):
            return table[:, resolve(node.col)] == node.value
        if isinstance(node, In):
            return np.isin(table[:, resolve(node.col)], list(node.values))
        if isinstance(node, Range):
            v = table[:, resolve(node.col)]
            mask = np.ones(len(table), dtype=bool)
            if node.lo is not None:
                mask &= v >= node.lo
            if node.hi is not None:
                mask &= v <= node.hi
            return mask
        if isinstance(node, Not):
            return ~ev(node.operand)
        if isinstance(node, And):
            mask = np.ones(len(table), dtype=bool)
            for c in node.operands:
                mask &= ev(c)
            return mask
        if isinstance(node, Or):
            mask = np.zeros(len(table), dtype=bool)
            for c in node.operands:
                mask |= ev(c)
            return mask
        raise TypeError(f"not a query expression: {node!r}")

    return ev(e)


def naive_eval_rows(table: np.ndarray, e: Expr,
                    names: Optional[Sequence[str]] = None) -> np.ndarray:
    return np.flatnonzero(naive_eval(table, e, names))


def naive_equality(table: np.ndarray, c: int, value_rank: int) -> np.ndarray:
    return np.flatnonzero(np.asarray(table)[:, c] == value_rank)


def naive_conjunction(table: np.ndarray, predicates: Dict[int, int]) -> np.ndarray:
    table = np.asarray(table)
    mask = np.ones(len(table), dtype=bool)
    for c, v in predicates.items():
        mask &= table[:, c] == v
    return np.flatnonzero(mask)


def naive_disjunction(table: np.ndarray, predicates: Dict[int, int]) -> np.ndarray:
    table = np.asarray(table)
    mask = np.zeros(len(table), dtype=bool)
    for c, v in predicates.items():
        mask |= table[:, c] == v
    return np.flatnonzero(mask)
