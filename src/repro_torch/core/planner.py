"""Logical query planner: rewrite an ``Expr`` tree into a physical plan.

Rewrites (paper-motivated — many bitmaps are combined per query, so plan
shape dominates):

* **NOT push-down** (De Morgan): ``~(a & b) -> ~a | ~b``, ``~(a | b) ->
  ~a & ~b``, ``~~a -> a``.  Complements end up directly above leaves, where
  EWAH's ``__invert__`` runs in the compressed domain.
* **Flattening**: associative AND/OR chains collapse into n-ary nodes so the
  executor can reduce them in one pass (tree order for OR, accumulative for
  AND).
* **Leaf lowering to minimal bitmap sets**: an ``Eq`` on a k-of-N-encoded
  column becomes the AND of its k physical bitmaps; ``In`` drops duplicate
  and out-of-domain ranks, shares nothing it does not need and folds to a
  constant when it covers the whole domain; ``Range`` clips to the column
  cardinality and lowers like the equivalent ``In``.
* **Cardinality-ordered AND**: operands of every AND are sorted by *true
  cardinality* — the memoized set-bit count of each physical bitmap
  (``ColumnIndex.bitmap_count``), the selectivity signal compressed size
  only approximates — with compressed words as the tiebreak, so the
  sparsest bitmap prunes the chain first.  ``use_counts=False`` falls back
  to the historical size-only ordering (pure metadata planning: no bitmap
  payload is ever decoded).

Beyond boolean filters the planner also lowers *aggregation statements*:
``plan_count`` wraps a filter into a ``PCount``, ``plan_agg`` a measure
aggregate into a ``PAgg``, and ``plan_group_agg`` expands one or two
columns into one value node per rank under a shared filter
(``PGroupAgg``) — the executor evaluates them entirely in the compressed
domain (memoized popcounts, interval slicing and the columns' run
catalogs; no result bitmap is materialized for an aggregate).  A
statement's filter is an ``Expr``, ``None``, or a bitmap already pinned
into the plan (``PPinned``).

Every lowered node also carries ``ckey``, a commutativity-normalized
structural key of its subtree (the plan-level analogue of
``expr.canonical_key``), which the executor uses to share *subexpression*
results — not just leaf bitmaps — across the statements of a batch.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .expr import And, Const, Eq, Expr, In, Not, Or, Range
from .index import BitmapIndex


# ---------------------------------------------------------------------------
# Physical plan nodes.  ``est_words`` estimates the compressed size (32-bit
# words) of the node's *result* — the unit the paper uses for both storage
# and logical-op cost.  ``est_rows`` estimates the result's true cardinality
# (set bits); -1 when the planner ran without count statistics.
# ---------------------------------------------------------------------------

@dataclass
class PlanNode:
    est_words: int = field(default=0, init=False)
    est_rows: int = field(default=-1, init=False)
    # commutativity-normalized structural key of this subtree (None only for
    # hand-built nodes); executors memoize composite results under it so a
    # subtree repeated across a batch of statements evaluates once
    ckey: Optional[tuple] = field(default=None, init=False)
    # provenance of ``est_rows`` on composite nodes: "bound" (min/sum
    # arithmetic over child estimates) or "sampled" (tightened by a sampled
    # set-interval overlap of the two most selective leaves)
    est_src: str = field(default="bound", init=False)
    # advisory physical-path hint from the planner's cost model: True when
    # the estimated operand density clears the (calibrated) EWAH-vs-kernel
    # crossover.  The executor re-decides from the operands' *actual*
    # compressed sizes; the hint makes ``explain`` output honest about the
    # expected physical path.
    kernel_hint: bool = field(default=False, init=False)


@dataclass
class PBitmap(PlanNode):
    """Load one physical bitmap (concatenated over partitions)."""
    col: int
    bitmap_id: int

    def __repr__(self):
        return f"bitmap[c{self.col}:b{self.bitmap_id}]~{self.est_words}w"


@dataclass
class PAnd(PlanNode):
    children: List[PlanNode]

    def __repr__(self):
        return "AND(" + ", ".join(map(repr, self.children)) + ")"


@dataclass
class POr(PlanNode):
    children: List[PlanNode]

    def __repr__(self):
        return "OR(" + ", ".join(map(repr, self.children)) + ")"


@dataclass
class PNot(PlanNode):
    child: PlanNode

    def __repr__(self):
        return f"NOT({self.child!r})"


@dataclass
class PConst(PlanNode):
    value: bool

    def __repr__(self):
        return "ALL" if self.value else "NONE"


@dataclass
class PDiff(PlanNode):
    """AND(pos) minus OR(neg): the optimizer's fusion of ``x & ~y`` chains
    into EWAH's native ``andnot`` — negated operands are subtracted in the
    compressed domain instead of materializing their (dense) complements."""
    pos: List[PlanNode]
    neg: List[PlanNode]

    def __repr__(self):
        return ("DIFF(" + ", ".join(map(repr, self.pos)) + " \\ "
                + ", ".join(map(repr, self.neg)) + ")")


@dataclass
class PPinned(PlanNode):
    """A concrete, already-evaluated bitmap pinned into a plan.

    The live-ingest layer builds aggregate plans whose filter is a bitmap
    it computed outside the planner (a per-shard result already masked by
    tombstones); the executor returns the pinned bitmap as-is.  ``ckey``
    stays ``None`` by design — a pinned bitmap has no structural identity,
    so no enclosing subtree is ever memoized under a key that could go
    stale when the pinned contents change."""
    bitmap: object  # EWAH (untyped to keep the planner import-light)

    def __repr__(self):
        return f"pinned[{self.bitmap!r}]"


@dataclass
class PCount(PlanNode):
    """COUNT(*) over a filter — evaluated as a memoized compressed-domain
    popcount of the filter's result; no rows are materialized."""
    child: PlanNode

    def __repr__(self):
        return f"COUNT({self.child!r})"


@dataclass
class PAgg(PlanNode):
    """Scalar sum/count/min/max of one measure under a filter.

    Evaluated by slicing the measure sidecar with the filter's
    ``set_intervals()`` — a vectorized gather + reduction over the selected
    rows, no row reconstruction.  The executor always returns the full
    ``(sum, count, min, max)`` partial so one evaluation (and one cache
    entry, coordinator-side) serves every projection including ``avg``."""
    measure: str
    filter: Optional[PlanNode]

    def __repr__(self):
        return f"AGG({self.measure!r}, where={self.filter!r})"


@dataclass
class PGroupAgg(PlanNode):
    """Grouped aggregates over one or two grouping columns.

    ``groups[j][v]`` is the lowered value node of rank ``v`` of grouping
    column ``cols[j]``.  With one column the executor maps each rank's
    intervals into the filter's dense coordinate space and reads sums off a
    prefix array; with two it intersects the *pairwise* segment catalogs of
    both columns (an elementary-segment sweep over their combined interval
    boundaries) so the (card_a x card_b) matrix costs one pass, not
    card_a*card_b bitmap ANDs.  ``measure=None`` computes counts only."""
    measure: Optional[str]
    cols: Tuple[int, ...]
    groups: Tuple[List[PlanNode], ...]
    filter: Optional[PlanNode]

    def __repr__(self):
        dims = "x".join(f"c{c}" for c in self.cols)
        return (f"GROUP_AGG({self.measure!r} by {dims}, "
                f"where={self.filter!r})")


# ---------------------------------------------------------------------------
# Logical rewrites (index-free).
# ---------------------------------------------------------------------------

def push_not(e: Expr, negate: bool = False) -> Expr:
    """Push negations down to the leaves via De Morgan's laws."""
    if isinstance(e, Not):
        return push_not(e.operand, not negate)
    if isinstance(e, And):
        ops = tuple(push_not(c, negate) for c in e.operands)
        return Or(ops) if negate else And(ops)
    if isinstance(e, Or):
        ops = tuple(push_not(c, negate) for c in e.operands)
        return And(ops) if negate else Or(ops)
    if isinstance(e, Const):
        return Const(not e.value) if negate else e
    return Not(e) if negate else e


def flatten(e: Expr) -> Expr:
    """Collapse nested associative AND/OR chains into n-ary nodes."""
    if isinstance(e, (And, Or)):
        cls = type(e)
        ops: List[Expr] = []
        for c in e.operands:
            fc = flatten(c)
            if isinstance(fc, cls):
                ops.extend(fc.operands)
            else:
                ops.append(fc)
        if len(ops) == 1:
            return ops[0]
        return cls(tuple(ops))
    if isinstance(e, Not):
        return Not(flatten(e.operand))
    return e


# ---------------------------------------------------------------------------
# Index-aware lowering + cost estimation.
# ---------------------------------------------------------------------------

def _nary_key(tag: str, children) -> Optional[tuple]:
    """Commutativity-normalized structural key of an n-ary plan node (child
    keys sorted, mirroring ``expr.canonical_key``)."""
    keys = [ch.ckey for ch in children]
    if any(k is None for k in keys):
        return None
    return (tag,) + tuple(sorted(keys, key=repr))


class Planner:
    def __init__(self, index: BitmapIndex, optimize: bool = True,
                 cost_model=None, use_counts: bool = True):
        from . import cost_model as _cm
        self.index = index
        self.optimize = optimize
        # order AND operands by true cardinality (memoized per-bitmap
        # popcounts) instead of compressed size alone; False restores pure
        # metadata planning (no bitmap payload decoded at plan time)
        self.use_counts = use_counts
        # calibrated EWAH-vs-kernel crossover (see repro_torch.core.cost_model)
        self.cost_model = cost_model if cost_model is not None \
            else _cm.get_default()
        self._sizes: dict = {}  # col -> np.ndarray of per-bitmap words

    # -- stats ------------------------------------------------------------
    def _bitmap_words(self, col: int, bid: int) -> int:
        if col not in self._sizes:
            self._sizes[col] = self.index.columns[col].bitmap_sizes()
        return int(self._sizes[col][bid])

    @property
    def _n_words(self) -> int:
        return -(-self.index.n_rows // 32)

    def _sort_key(self, node: PlanNode) -> tuple:
        """Operand order for n-ary nodes: true cardinality first when count
        statistics are on (compressed words break ties), size-only
        otherwise."""
        if self.use_counts and node.est_rows >= 0:
            return (node.est_rows, node.est_words)
        return (node.est_words,)

    # -- lowering ---------------------------------------------------------
    def plan(self, e: Expr) -> PlanNode:
        if self.optimize:
            e = flatten(push_not(e))
        return self._lower(e)

    def _filter(self, e) -> Optional[PlanNode]:
        """A statement's filter plan: an ``Expr`` lowered, ``None`` (no
        filter) or an already-evaluated ``PPinned`` bitmap as it is."""
        return self.plan(e) if isinstance(e, Expr) else e

    def plan_count(self, e: Optional[Expr] = None) -> PCount:
        """Lower a COUNT statement: ``e is None`` counts every row."""
        child = self._filter(e) if e is not None else self._const(True)
        node = PCount(child)
        node.est_words = 0
        node.est_rows = child.est_rows
        if child.ckey is not None:  # pinned filter: no structural identity
            node.ckey = ("count", child.ckey)
        return node

    def _measure_check(self, name: str) -> None:
        measures = getattr(self.index, "measures", None) or {}
        if name not in measures:
            raise KeyError(
                f"unknown measure {name!r}; this index declares "
                f"{sorted(measures)}")

    def plan_agg(self, measure: str, e: Optional[Expr] = None) -> PAgg:
        """Lower a scalar measure aggregate (sum/avg/min/max/count of a
        measure) under an optional filter."""
        self._measure_check(measure)
        filt = self._filter(e)
        node = PAgg(measure, filt)
        node.est_words = 0
        node.est_rows = filt.est_rows if filt is not None else \
            self.index.n_rows
        if filt is not None and filt.ckey is None:
            node.ckey = None  # pinned filter: no stable structural identity
        else:
            node.ckey = ("agg", measure,
                         None if filt is None else filt.ckey)
        return node

    def plan_group_agg(self, measure: Optional[str], cols,
                       e: Optional[Expr] = None) -> PGroupAgg:
        """Lower a grouped aggregate over one or two grouping columns.

        ``measure=None`` lowers a multi-column COUNT(*) group-by (the
        analogue of ``plan_count``, per value or pair of values)."""
        if measure is not None:
            self._measure_check(measure)
        cols = [cols] if isinstance(cols, (int, np.integer, str)) else \
            list(cols)
        if not (1 <= len(cols) <= 2):
            raise ValueError(
                f"group_agg takes 1 or 2 grouping columns, got {len(cols)}")
        resolved = []
        groups = []
        for col in cols:
            c = self.index.resolve_column(col)
            if c in resolved:
                raise ValueError(
                    f"duplicate grouping column {col!r}")
            resolved.append(c)
            enc = self.index.columns[c].encoder
            codes = enc.codes(np.arange(self.index.card(c), dtype=np.int64))
            groups.append([self._value_node(c, code) for code in codes])
        filt = self._filter(e)
        node = PGroupAgg(measure, tuple(resolved), tuple(groups), filt)
        node.est_words = 0
        node.est_rows = filt.est_rows if filt is not None else \
            self.index.n_rows
        if filt is not None and filt.ckey is None:
            node.ckey = None
        else:
            node.ckey = ("gagg", measure, tuple(resolved),
                         None if filt is None else filt.ckey)
        return node

    def _lower(self, e: Expr) -> PlanNode:
        if isinstance(e, Const):
            return self._const(e.value)
        if isinstance(e, Eq):
            return self._lower_eq(e)
        if isinstance(e, In):
            return self._lower_in(e.col, e.values)
        if isinstance(e, Range):
            return self._lower_range(e)
        if isinstance(e, Not):
            child = self._lower(e.operand)
            if isinstance(child, PConst):
                return self._const(not child.value)
            if isinstance(child, PNot):  # complement lowering may re-negate
                return child.child
            node = PNot(child)
            # complement flips clean-run types and inverts literals in
            # place, so its compressed size matches the child's
            node.est_words = child.est_words
            if child.est_rows >= 0:
                node.est_rows = self.index.n_rows - child.est_rows
            node.ckey = ("not", child.ckey)
            return node
        if isinstance(e, And):
            return self._lower_nary(e.operands, PAnd)
        if isinstance(e, Or):
            return self._lower_nary(e.operands, POr)
        raise TypeError(f"not a query expression: {e!r}")

    def _const(self, value: bool) -> PConst:
        node = PConst(value)
        node.est_words = 1 if not value else self._n_words
        node.est_rows = self.index.n_rows if value else 0
        node.ckey = ("const", value)
        return node

    def _leaf(self, col: int, bid: int) -> PBitmap:
        node = PBitmap(col, bid)
        node.est_words = self._bitmap_words(col, bid)
        if self.use_counts:
            # the *true* cardinality (memoized compressed-domain popcount):
            # exact selectivity for a leaf, the paper-motivated upgrade over
            # compressed size as the AND-ordering signal
            node.est_rows = self.index.columns[col].bitmap_count(bid)
        node.ckey = ("bm", col, bid)
        return node

    def _value_node(self, col: int, code) -> PlanNode:
        """One value rank on a k-of-N column -> AND of its k bitmaps."""
        leaves = [self._leaf(col, int(b)) for b in code]
        if len(leaves) == 1:
            return leaves[0]
        if self.optimize:
            leaves.sort(key=self._sort_key)
        node = PAnd(leaves)
        node.est_words = min(l.est_words for l in leaves)
        node.est_rows = min((l.est_rows for l in leaves), default=-1) \
            if all(l.est_rows >= 0 for l in leaves) else -1
        node.ckey = _nary_key("and", leaves)
        return node

    def _lower_eq(self, e: Eq) -> PlanNode:
        c = self.index.resolve_column(e.col)
        if not (0 <= e.value < self.index.card(c)):
            return self._const(False)  # unseen value matches no rows
        code = self.index.columns[c].encoder.codes(np.array([e.value]))[0]
        return self._value_node(c, code)

    def _lower_in(self, col, values: Tuple[int, ...]) -> PlanNode:
        c = self.index.resolve_column(col)
        card = self.index.card(c)
        # dedupe + drop out-of-domain ranks (minimal bitmap set)
        vals = sorted({int(v) for v in values if 0 <= int(v) < card})
        if not vals:
            return self._const(False)
        if len(vals) == card:
            return self._const(True)
        if self.optimize and len(vals) > card - len(vals):
            # minimal bitmap set: a value set covering most of the domain is
            # cheaper as the complement of its (smaller) inverse set; every
            # row holds exactly one value, so NOT(inverse) is exact, and an
            # enclosing AND fuses the NOT into a compressed-domain andnot
            comp = sorted(set(range(card)) - set(vals))
            child = self._lower_in(c, tuple(comp))
            node = PNot(child)
            node.est_words = child.est_words
            if child.est_rows >= 0:
                node.est_rows = self.index.n_rows - child.est_rows
            node.ckey = ("not", child.ckey)
            return node
        enc = self.index.columns[c].encoder
        codes = enc.codes(np.asarray(vals, dtype=np.int64))
        if enc.k == 1:
            # distinct ranks may still share bitmaps only at k>1; at k=1 the
            # minimal set is just the distinct bitmap ids
            bids = sorted({int(b) for b in codes[:, 0]})
            children: List[PlanNode] = [self._leaf(c, b) for b in bids]
        else:
            children = [self._value_node(c, code) for code in codes]
        if len(children) == 1:
            return children[0]
        if self.optimize:
            children.sort(key=self._sort_key)
        node = POr(children)
        node.est_words = min(sum(ch.est_words for ch in children), self._n_words)
        node.est_rows = self._or_rows(children)
        node.ckey = _nary_key("or", children)
        return node

    def _lower_range(self, e: Range) -> PlanNode:
        c = self.index.resolve_column(e.col)
        card = self.index.card(c)
        lo = 0 if e.lo is None else max(int(e.lo), 0)
        hi = card - 1 if e.hi is None else min(int(e.hi), card - 1)
        if lo > hi:
            return self._const(False)
        if lo == 0 and hi == card - 1:
            return self._const(True)
        return self._lower_in(c, tuple(range(lo, hi + 1)))

    def _lower_nary(self, operands, cls) -> PlanNode:
        children = [self._lower(op) for op in operands]
        # constant folding
        if cls is PAnd:
            if any(isinstance(ch, PConst) and not ch.value for ch in children):
                return self._const(False)
            children = [ch for ch in children
                        if not (isinstance(ch, PConst) and ch.value)]
            if not children:
                return self._const(True)
        else:
            if any(isinstance(ch, PConst) and ch.value for ch in children):
                return self._const(True)
            children = [ch for ch in children
                        if not (isinstance(ch, PConst) and not ch.value)]
            if not children:
                return self._const(False)
        if len(children) == 1:
            return children[0]
        if self.optimize:
            # sparsest first: for AND the rarest bitmap prunes the chain,
            # for OR small results keep intermediate unions small
            children.sort(key=self._sort_key)
            if cls is PAnd:
                neg = [ch.child for ch in children if isinstance(ch, PNot)]
                pos = [ch for ch in children if not isinstance(ch, PNot)]
                if pos and neg:  # fuse x & ~y -> andnot (no complement)
                    node = PDiff(pos, neg)
                    node.est_words = min(ch.est_words for ch in pos)
                    node.est_rows = self._and_rows(pos)
                    self._refine_nary(node, pos, "and")
                    node.ckey = ("diff", _nary_key("and", pos),
                                 _nary_key("or", neg))
                    return node
        node = cls(children)
        if cls is PAnd:
            node.est_words = min(ch.est_words for ch in children)
            node.est_rows = self._and_rows(children)
        else:
            node.est_words = min(sum(ch.est_words for ch in children),
                                 self._n_words)
            node.est_rows = self._or_rows(children)
        self._refine_nary(node, children, "and" if cls is PAnd else "or")
        node.ckey = _nary_key("and" if cls is PAnd else "or", children)
        if self._n_words:
            density = (sum(ch.est_words for ch in children)
                       / (len(children) * self._n_words))
            node.kernel_hint = density >= self.cost_model.dense_threshold
        return node

    def _and_rows(self, children) -> int:
        rows = [ch.est_rows for ch in children]
        return min(rows) if rows and all(r >= 0 for r in rows) else -1

    def _or_rows(self, children) -> int:
        rows = [ch.est_rows for ch in children]
        if not rows or any(r < 0 for r in rows):
            return -1
        return min(sum(rows), self.index.n_rows)

    # -- sampled-overlap cardinality refinement -----------------------------
    # The min/sum bounds above ignore correlation entirely: an AND of two
    # half-selective bitmaps estimates n/2 whether they are identical or
    # disjoint.  When count statistics are on, the estimate of an n-ary
    # AND/OR is tightened by *measuring* the overlap of its two most
    # selective bitmap leaves over a sampled prefix of their (memoized)
    # ``set_intervals()`` views, scaled to the full table and clamped back
    # inside the provable bounds.  Sampling stops after ~SAMPLE_INTERVALS
    # intervals per leaf and skips partitions so literal-heavy that the
    # interval expansion would dwarf the plan itself.
    SAMPLE_INTERVALS = 64
    SAMPLE_MAX_WORDS = 256

    def _leaf_intervals(self, leaf: "PBitmap"):
        """Sampled set-interval prefix of one leaf bitmap.

        Returns ``(starts, ends, covered_bits)`` where the intervals are
        complete over rows ``[0, covered_bits)``, or ``None`` when even the
        first partition is too literal-heavy to expand cheaply."""
        ci = self.index.columns[leaf.col]
        ss: List[np.ndarray] = []
        es: List[np.ndarray] = []
        off = 0
        n_iv = 0
        for part in ci.bitmaps:
            bm = part[leaf.bitmap_id]
            if bm.size_words > self.SAMPLE_MAX_WORDS:
                break
            s, e = bm.set_intervals()
            ss.append(s + off)
            es.append(e + off)
            off += bm.n_bits
            n_iv += len(s)
            if n_iv >= self.SAMPLE_INTERVALS:
                break
        if off == 0:
            return None
        empty = np.empty(0, np.int64)
        return (np.concatenate(ss) if ss else empty,
                np.concatenate(es) if es else empty, off)

    def _refine_nary(self, node: PlanNode, children, kind: str) -> None:
        if not (self.use_counts and self.optimize and self.index.n_rows):
            return
        leaves = [ch for ch in children
                  if isinstance(ch, PBitmap) and ch.est_rows >= 0]
        if len(leaves) < 2 or node.est_rows < 0:
            return
        a, b = sorted(leaves, key=lambda l: l.est_rows)[:2]
        iva, ivb = self._leaf_intervals(a), self._leaf_intervals(b)
        if iva is None or ivb is None:
            return
        x = min(iva[2], ivb[2])
        if x <= 0:
            return
        sa, ea = _clip_intervals(iva[0], iva[1], x)
        sb, eb = _clip_intervals(ivb[0], ivb[1], x)
        ca = int((ea - sa).sum())
        cb = int((eb - sb).sum())
        ov = int(_coverage_at(sb, eb, ea).sum()
                 - _coverage_at(sb, eb, sa).sum())
        n = self.index.n_rows
        others = [ch.est_rows for ch in children if ch is not a and ch is not b]
        if any(r < 0 for r in others):
            return
        if kind == "and":
            pair = round(ov * n / x)
            lo = max(0, a.est_rows + b.est_rows - n)
            pair = min(max(pair, lo), a.est_rows, b.est_rows)
            est = min([pair] + others) if others else pair
        else:
            union = round((ca + cb - ov) * n / x)
            union = min(max(union, a.est_rows, b.est_rows),
                        a.est_rows + b.est_rows, n)
            est = min(union + sum(others), n)
        node.est_rows = int(est)
        node.est_src = "sampled"


def _clip_intervals(s: np.ndarray, e: np.ndarray, x: int):
    """Clip sorted disjoint half-open intervals to ``[0, x)``."""
    m = s < x
    return s[m], np.minimum(e[m], x)


def _coverage_at(fs: np.ndarray, fe: np.ndarray,
                 xs: np.ndarray) -> np.ndarray:
    """Covered length below each ``x`` of the sorted disjoint intervals
    ``[fs, fe)`` (prefix-popcount function; one ``searchsorted`` pass)."""
    if len(fs) == 0:
        return np.zeros(len(xs), np.int64)
    pref = np.concatenate(([0], np.cumsum(fe - fs)))
    i = np.searchsorted(fs, xs, side="right") - 1
    i0 = np.maximum(i, 0)
    inside = np.clip(xs - fs[i0], 0, fe[i0] - fs[i0])
    return np.where(i >= 0, pref[i0] + inside, 0)


def plan(index: BitmapIndex, e: Expr, optimize: bool = True) -> PlanNode:
    """Plan an expression against an index; ``optimize=False`` keeps the
    user's tree shape (baseline for benchmarks)."""
    return Planner(index, optimize=optimize).plan(e)


def _est(node: PlanNode) -> str:
    """Size estimate suffix: compressed words, plus true rows when the
    planner ran with count statistics (the selectivity that now orders
    ANDs)."""
    rows = f",{node.est_rows}r" if node.est_rows >= 0 else ""
    return f"~{node.est_words}w{rows}"


def _src(node: PlanNode) -> str:
    """Estimate-source marker for composite nodes: where ``est_rows`` came
    from — interval-sampled overlap or the plain min/sum bound."""
    if node.est_rows < 0:
        return ""
    return f" [est:{node.est_src}]"


def explain(node: PlanNode, depth: int = 0) -> str:
    """Human-readable plan tree with size + cardinality estimates."""
    pad = "  " * depth
    if isinstance(node, PBitmap):
        return f"{pad}bitmap c{node.col}:b{node.bitmap_id} {_est(node)}"
    if isinstance(node, PConst):
        return f"{pad}{'ALL' if node.value else 'NONE'}"
    if isinstance(node, PPinned):
        return f"{pad}pinned bitmap ({node.bitmap!r})"
    if isinstance(node, PNot):
        return f"{pad}NOT {_est(node)}\n" + explain(node.child, depth + 1)
    if isinstance(node, PDiff):
        lines = [f"{pad}ANDNOT {_est(node)}{_src(node)}"]
        lines += [explain(ch, depth + 1) for ch in node.pos]
        lines += [f"{pad}  minus:"]
        lines += [explain(ch, depth + 2) for ch in node.neg]
        return "\n".join(lines)
    if isinstance(node, PCount):
        return f"{pad}COUNT (compressed-domain popcount)\n" \
            + explain(node.child, depth + 1)
    if isinstance(node, PAgg):
        lines = [f"{pad}AGG {node.measure} (interval-sliced measure "
                 f"reduction) {_est(node)}"]
        if node.filter is not None:
            lines += [f"{pad}  where:", explain(node.filter, depth + 2)]
        return "\n".join(lines)
    if isinstance(node, PGroupAgg):
        dims = " x ".join(f"c{c}({len(g)} groups)"
                          for c, g in zip(node.cols, node.groups))
        what = node.measure if node.measure is not None else "count(*)"
        lines = [f"{pad}GROUP-AGG {what} by {dims} "
                 f"(filtered-domain segment sweep)"]
        if node.filter is not None:
            lines += [f"{pad}  where:", explain(node.filter, depth + 2)]
        return "\n".join(lines)
    name = "AND" if isinstance(node, PAnd) else "OR"
    path = " [kernel]" if node.kernel_hint else ""
    lines = [f"{pad}{name} {_est(node)}{_src(node)}{path}"]
    lines += [explain(ch, depth + 1) for ch in node.children]
    return "\n".join(lines)
