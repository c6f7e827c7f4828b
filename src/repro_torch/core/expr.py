"""Composable query expressions over a bitmap index.

The AST has three leaf predicates — ``Eq`` (column == value rank), ``In``
(column IN a value set) and ``Range`` (lo <= column <= hi, either bound
open) — and three connectives: ``And``, ``Or``, ``Not``.  Expressions are
built with operator overloading on column handles:

    from repro_torch.core import col
    q = (col("region") == 3) & ~col("day").between(10, 20)
    q = (col(0) == 1) | col(2).isin([4, 5, 6])

Columns are referenced by integer position or, when the index was built with
``column_names``, by name; names resolve at planning time.  Expression nodes
are immutable and compare structurally, so plans can be cached by expression.

The logical planner (``repro_torch.core.planner``) rewrites these trees (De Morgan
push-down, AND/OR flattening, Range/In lowering to minimal bitmap sets) and
the executor (``repro_torch.core.executor``) runs them over EWAH bitmaps or the
Pallas word-logical kernels.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional, Tuple, Union

ColKey = Union[int, str]


def _cname(key: ColKey) -> str:
    return key if isinstance(key, str) else f"c{key}"


class Expr:
    """Base class for query-expression nodes."""

    __slots__ = ()

    def __and__(self, other: "Expr") -> "And":
        return And(_operands(self, And) + _operands(other, And))

    def __or__(self, other: "Expr") -> "Or":
        return Or(_operands(self, Or) + _operands(other, Or))

    def __invert__(self) -> "Expr":
        if isinstance(self, Not):  # double negation cancels at construction
            return self.operand
        return Not(self)

    def __bool__(self) -> bool:
        # Python's `and`/`or` and chained comparisons (0 <= col(0) <= 5)
        # would silently drop operands; fail loudly instead
        raise TypeError(
            "query expressions have no truth value: use & | ~ instead of "
            "and/or/not, and col(c).between(lo, hi) instead of chained "
            "comparisons")

    def columns(self) -> Tuple[ColKey, ...]:
        """All column keys referenced by this expression (depth-first)."""
        out = []
        _collect_columns(self, out)
        return tuple(out)

    def cache_key(self) -> tuple:
        """Hashable structural key for result/plan caches (see
        ``canonical_key``); commutatively equal expressions share a key."""
        return canonical_key(self)


def _operands(e: Expr, cls) -> Tuple[Expr, ...]:
    return e.operands if isinstance(e, cls) else (e,)


def _collect_columns(e: Expr, out: list) -> None:
    if isinstance(e, (Eq, In, Range)):
        out.append(e.col)
    elif isinstance(e, Not):
        _collect_columns(e.operand, out)
    elif isinstance(e, (And, Or)):
        for c in e.operands:
            _collect_columns(c, out)


@dataclass(frozen=True)
class Eq(Expr):
    """column == value rank."""
    col: ColKey
    value: int

    def __repr__(self):
        return f"({_cname(self.col)} == {self.value})"


@dataclass(frozen=True)
class In(Expr):
    """column IN a set of value ranks (deduplicated and sorted on build)."""
    col: ColKey
    values: Tuple[int, ...]

    def __post_init__(self):
        vals = tuple(sorted({int(v) for v in self.values}))
        object.__setattr__(self, "values", vals)

    def __repr__(self):
        return f"({_cname(self.col)} in {list(self.values)})"


@dataclass(frozen=True)
class Range(Expr):
    """lo <= column <= hi (inclusive); ``None`` leaves a side unbounded."""
    col: ColKey
    lo: Optional[int]
    hi: Optional[int]

    def __repr__(self):
        lo = "-inf" if self.lo is None else self.lo
        hi = "+inf" if self.hi is None else self.hi
        return f"({lo} <= {_cname(self.col)} <= {hi})"


@dataclass(frozen=True)
class And(Expr):
    operands: Tuple[Expr, ...]

    def __post_init__(self):
        object.__setattr__(self, "operands", tuple(self.operands))

    def __repr__(self):
        return "(" + " & ".join(map(repr, self.operands)) + ")"


@dataclass(frozen=True)
class Or(Expr):
    operands: Tuple[Expr, ...]

    def __post_init__(self):
        object.__setattr__(self, "operands", tuple(self.operands))

    def __repr__(self):
        return "(" + " | ".join(map(repr, self.operands)) + ")"


@dataclass(frozen=True)
class Not(Expr):
    operand: Expr

    def __repr__(self):
        return f"~{self.operand!r}"


@dataclass(frozen=True)
class Const(Expr):
    """Constant predicate (all rows / no rows) — produced by lowering, e.g.
    a ``Range`` covering the whole domain or an ``In`` over no valid values."""
    value: bool

    def __repr__(self):
        return "ALL" if self.value else "NONE"


def canonical_key(e: Expr) -> tuple:
    """Nested-tuple structural key of an expression, usable as a dict key.

    Expression nodes are frozen dataclasses, so ``hash(e)``/``e == f`` are
    already structural; the canonical key goes one step further for caching:
    ``And``/``Or`` operands commute for results, so their child keys are
    sorted — ``a & b`` and ``b & a`` land on the same cache entry.  (Sorting
    is by ``repr`` of the child key, since column keys mix ints and strs.)
    """
    if isinstance(e, Eq):
        return ("eq", e.col, e.value)
    if isinstance(e, In):
        return ("in", e.col) + e.values
    if isinstance(e, Range):
        return ("range", e.col, e.lo, e.hi)
    if isinstance(e, Const):
        return ("const", e.value)
    if isinstance(e, Not):
        return ("not", canonical_key(e.operand))
    if isinstance(e, (And, Or)):
        tag = "and" if isinstance(e, And) else "or"
        return (tag,) + tuple(sorted((canonical_key(c) for c in e.operands),
                                     key=repr))
    raise TypeError(f"not a query expression: {e!r}")


def to_wire(e: Expr) -> dict:
    """Expr tree -> JSON-serializable wire object (see ``from_wire``).

    The wire format mirrors the AST and is shared by the HTTP serving layer
    (``repro_torch.serve.query_api``) and the write-ahead log
    (``repro_torch.core.wal``), which persists delete predicates as expressions so
    crash replay re-evaluates them in original order.
    """
    if isinstance(e, Eq):
        return {"op": "eq", "col": e.col, "value": e.value}
    if isinstance(e, In):
        return {"op": "in", "col": e.col, "values": list(e.values)}
    if isinstance(e, Range):
        out = {"op": "range", "col": e.col}
        if e.lo is not None:
            out["lo"] = e.lo
        if e.hi is not None:
            out["hi"] = e.hi
        return out
    if isinstance(e, And):
        return {"op": "and", "args": [to_wire(c) for c in e.operands]}
    if isinstance(e, Or):
        return {"op": "or", "args": [to_wire(c) for c in e.operands]}
    if isinstance(e, Not):
        return {"op": "not", "arg": to_wire(e.operand)}
    if isinstance(e, Const):
        return {"op": "const", "value": bool(e.value)}
    raise TypeError(f"cannot serialize {e!r}")


def from_wire(obj: dict) -> Expr:
    """JSON wire object -> Expr tree (raises ValueError on malformed input)."""
    if not isinstance(obj, dict) or "op" not in obj:
        raise ValueError(f"expression must be an object with 'op': {obj!r}")
    op = obj["op"]
    if op == "eq":
        return Eq(obj["col"], int(obj["value"]))
    if op == "in":
        return In(obj["col"], tuple(int(v) for v in obj["values"]))
    if op == "range":
        lo, hi = obj.get("lo"), obj.get("hi")
        if lo is None and hi is None:
            raise ValueError("range needs at least one of lo/hi")
        return Range(obj["col"], None if lo is None else int(lo),
                     None if hi is None else int(hi))
    if op in ("and", "or"):
        args = [from_wire(a) for a in obj["args"]]
        if not args:
            raise ValueError(f"{op} needs at least one argument")
        return And(tuple(args)) if op == "and" else Or(tuple(args))
    if op == "not":
        return Not(from_wire(obj["arg"]))
    if op == "const":
        return Const(bool(obj["value"]))
    raise ValueError(f"unknown op {op!r}")


class Col:
    """Column handle: comparison operators build expression leaves."""

    __slots__ = ("key",)

    def __init__(self, key: ColKey):
        self.key = key

    def __eq__(self, value) -> Eq:  # type: ignore[override]
        return Eq(self.key, int(value))

    def __ne__(self, value) -> Expr:  # type: ignore[override]
        return Not(Eq(self.key, int(value)))

    def __hash__(self):
        return hash(("Col", self.key))

    def isin(self, values: Iterable[int]) -> In:
        return In(self.key, tuple(int(v) for v in values))

    def between(self, lo: int, hi: int) -> Range:
        """lo <= column <= hi, both bounds inclusive."""
        return Range(self.key, int(lo), int(hi))

    def __le__(self, value) -> Range:
        return Range(self.key, None, int(value))

    def __lt__(self, value) -> Range:
        return Range(self.key, None, int(value) - 1)

    def __ge__(self, value) -> Range:
        return Range(self.key, int(value), None)

    def __gt__(self, value) -> Range:
        return Range(self.key, int(value) + 1, None)

    def __repr__(self):
        return f"col({self.key!r})"


def col(key: ColKey) -> Col:
    """Entry point of the expression API: ``col(0)`` or ``col("region")``."""
    return Col(key)
