"""``Dataset``: the one-object façade over the whole fact-table lifecycle.

The paper's pipeline — order columns, sort the fact table, build k-of-N
EWAH bitmap indexes, query them.  ``Dataset`` owns that composition end to
end while every piece stays importable for power users:

    from repro_torch.core import Dataset, col

    ds = Dataset.from_rows(table, columns=["region", "day", "user"],
                           sort="lex")        # device="cuda" by default

    q = ds.query().where(col("region") == 3)
    q.count()                                 #   compressed-domain popcount
    q.group_by("day").count()                 #   np.bincount-shaped vector
    q.top_k("day", 5)                         #   [(value_rank, count), ...]
    q.rows(limit=100)                         #   row ids, when you want rows

The dataset's ``device`` is where the executor's kernel path runs and where
its dense operands stay cached (``"cuda"`` unless the caller passes
``"cpu"``; there is no fallback).  This package holds the in-memory,
monolithic path: sharding, the store, live ingest, re-layout and serving
raise ``NotImplementedError`` naming the ROADMAP item that ports them.

Statements, not just filters: ``query()`` returns a small immutable builder
whose terminal methods compile to aggregation plan nodes (``PCount`` /
``PGroupCount``) evaluated **in the compressed domain** — counts are
memoized EWAH popcounts, group-by intersects each value bitmap with the
shared filter by run-interval arithmetic.  No
aggregate ever materializes a global result bitmap, mirroring how
Lemire/Kaser/Aouiche and the Roaring line evaluate aggregate workloads over
attribute-value bitmaps without decompressing.

Out-of-core builds: ``from_rows(..., spill_dir=...)`` streams chunk-sorted
runs to disk, merges them back in bounded windows and feeds the index
builder chunk by chunk (full-sort compression, O(chunk + partition)
memory); ``from_chunks`` accepts a chunk iterator whose total size is
unknown up front.  Neither needs the store.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

import torch

from repro_torch.kernels.ops import resolve_device
from .expr import Expr
from .index import WORD_ROWS, BitmapIndex, IndexBuilder
from .layout import LayoutDecision, LayoutStats
from .sorting import (SortStats, external_merge_sort_perm,
                      external_sorted_chunks, order_columns_freq_aware)

DEFAULT_CHUNK_ROWS = 8192

Device = Union[str, torch.device]


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not in repro_torch yet: it is ported with ROADMAP "
        f"Queue 1 {item}")


def _table_cards(table: np.ndarray) -> List[int]:
    n, d = table.shape
    return [int(table[:, c].max()) + 1 if n else 1 for c in range(d)]


def top_k_from_counts(counts: np.ndarray, k: int) -> List[Tuple[int, int]]:
    """The ``k`` largest entries of a group-count vector as
    ``[(value_rank, count), ...]``: descending count, ties by ascending
    rank, zero-count values never included.  Shared by ``Query.top_k`` and
    the serving layer's top-k statement."""
    counts = np.asarray(counts)
    nz = np.flatnonzero(counts)
    order = nz[np.lexsort((nz, -counts[nz]))][:max(int(k), 0)]
    return [(int(v), int(counts[v])) for v in order]


def top_k_from_values(values: np.ndarray, counts: np.ndarray,
                      k: int) -> List[Tuple[int, Union[int, float]]]:
    """The ``k`` largest entries of a per-group value vector (measure sums)
    as ``[(value_rank, value), ...]``: descending value, ties by ascending
    rank — the *same* deterministic tie-break as ``top_k_from_counts``, so
    mono, sharded and cluster top-k orderings agree.  Groups with zero
    rows (``counts == 0``) never appear, even when their value is 0."""
    values = np.asarray(values)
    counts = np.asarray(counts)
    nz = np.flatnonzero(counts)
    order = nz[np.lexsort((nz, -values[nz]))][:max(int(k), 0)]
    if values.dtype.kind == "f":
        return [(int(v), float(values[v])) for v in order]
    return [(int(v), int(values[v])) for v in order]


class Dataset:
    """A queryable fact table: index + names + (optionally) the sorted rows.

    Build with ``from_rows`` / ``from_chunks``; construct directly only to
    wrap an index you already have (for instance one carried over with
    ``index_from_numpy``).  The sorted table is retained on in-memory builds
    (the pipeline's row-permutation bookkeeping) and absent on spilled
    builds, where rows never lived in memory.
    """

    def __init__(self, index: BitmapIndex,
                 column_names: Optional[Sequence[str]] = None,
                 table: Optional[np.ndarray] = None,
                 row_perm: Optional[np.ndarray] = None,
                 dir_path: Optional[str] = None,
                 sort_order: Optional[Sequence[int]] = None,
                 cards: Optional[Sequence[int]] = None,
                 k: int = 1, allocation: str = "alpha",
                 partition_rows: Optional[int] = None,
                 container: str = "run",
                 layout: Optional[LayoutDecision] = None,
                 device: Device = "cuda"):
        self.device = resolve_device(device)
        self.index = index
        names = list(column_names) if column_names is not None \
            else index.column_names
        self.column_names = names
        self.table = table
        self.row_perm = row_perm
        self.dir_path = dir_path
        self.sort_order = list(sort_order) if sort_order is not None else None
        self._cards = list(cards) if cards is not None else None
        self._k = int(k)
        self._allocation = allocation
        self._partition_rows = partition_rows
        self._container = container
        self._layout = layout

    @property
    def layout(self) -> Optional[LayoutDecision]:
        """The frozen physical-layout decision (order, remaps, advisor
        provenance), when one was made."""
        return self._layout

    @property
    def remaps(self) -> Optional[List[Optional[np.ndarray]]]:
        """Per-column frequency remaps in effect (None = no remapping)."""
        return self._layout.remaps if self._layout is not None else None

    # -- construction -------------------------------------------------------
    @classmethod
    def from_rows(cls, rows: np.ndarray,
                  columns: Optional[Sequence[str]] = None, *,
                  sort: Union[str, Sequence[int]] = "lex",
                  k: int = 1, allocation: str = "alpha",
                  cards: Optional[Sequence[int]] = None,
                  shards: int = 0,
                  partition_rows: Optional[int] = None,
                  spill_dir: Optional[str] = None,
                  chunk_rows: int = DEFAULT_CHUNK_ROWS,
                  sort_stats: Optional[SortStats] = None,
                  container: Optional[str] = None,
                  remap: bool = False,
                  layout: Optional[LayoutDecision] = None,
                  measures: Optional[Dict] = None,
                  device: Device = "cuda") -> "Dataset":
        """Sort + index a fact table of integer value ranks in one call.

        ``sort`` is ``"lex"`` (lexicographic with the paper's §4.3
        frequency-aware column order — the compression recipe), ``"none"``
        (index rows as given), or an explicit column-order sequence.  The
        sort always runs as an external merge over ``chunk_rows``-row runs
        (bit-identical permutation to ``lex_sort``); with ``spill_dir`` the
        runs live on disk and sorted chunks stream straight into the index
        builder, so peak memory is O(chunk + partition) and the sorted
        table is *not* retained.  ``shards > 1`` (word-aligned row shards)
        raises ``NotImplementedError`` until ``core/shard.py`` is ported;
        ``cards`` pins global cardinalities when ``rows`` may not contain
        every value.  ``container`` is ``"run"`` (plain word-aligned
        run-list bitmaps), ``"auto"`` (Roaring-style per-chunk containers
        where the cost model says they pay off), or ``None`` to pick by
        sort: sorted builds stay pure run-list (their bitmaps are runs
        already), unsorted ``sort="none"`` builds use ``"auto"``.

        ``measures`` declares numeric *measure columns* (``{name: 1-D
        int/float array}``, one value per input row): they are permuted by
        the same sort as the rows — the data behind
        ``query().sum("sales")`` and friends.  Integer measures become
        int64, floating ones float64.  Spilled builds (``spill_dir``) do
        not support measures (the row permutation never materializes).

        ``remap=True`` additionally applies histogram-aware value
        remapping (``repro_torch.core.layout``): a streaming pass collects
        per-column value histograms, frequent values get adjacent encoded
        ranks, and the sort + encoders both use the remapped ranks — runs
        get longer, query results stay in original ranks.  ``layout``
        short-circuits both: a pre-frozen ``LayoutDecision`` (e.g. from
        ``from_chunks``'s streaming collector) is obeyed verbatim and no
        statistics pass runs here.

        ``device`` is where queries run the kernel path (``"cuda"`` by
        default; raises, before any work, when CUDA is absent).
        """
        device = resolve_device(device)
        if shards and shards > 1:
            raise _not_ported("Dataset.from_rows(shards=...)",
                              "item 10 (core/shard.py)")
        rows = np.asarray(rows)
        if rows.ndim != 2:
            raise ValueError(f"rows must be 2-D, got shape {rows.shape}")
        n, d = rows.shape
        if columns is not None and len(columns) != d:
            raise ValueError(
                f"columns has {len(columns)} names for {d} columns")
        if layout is not None:
            decision = layout
            cards = list(decision.cards) if decision.cards is not None \
                else (list(cards) if cards is not None else _table_cards(rows))
            order = list(decision.order) if decision.order is not None \
                else None
        else:
            cards = list(cards) if cards is not None else _table_cards(rows)
            if remap:
                stats = LayoutStats()
                for s in range(0, max(n, 1), chunk_rows):
                    stats.observe(rows[s:s + chunk_rows])
                decision = stats.decision(sort=sort, remap=True, cards=cards)
                order = decision.order
            else:
                order = cls._resolve_sort(sort, rows, cards, d)
                decision = LayoutDecision(order=order, remaps=None,
                                          cards=cards, n_rows=n)
        remaps = decision.remaps
        names = list(columns) if columns is not None else None
        if container is None:
            container = "run" if order is not None else "auto"
        if measures is not None:
            from .measures import normalize_measures
            if spill_dir is not None:
                raise ValueError(
                    "measures are not supported with spill_dir builds: the "
                    "sort permutation never materializes out-of-core, so "
                    "the sidecar could not be reordered to match the rows")
            measures = normalize_measures(measures, n)

        if order is not None and spill_dir is not None:
            # out-of-core: sorted chunks stream off merged on-disk runs and
            # straight into the builder(s); the permutation never exists
            part = partition_rows
            if part is None:
                part = max(chunk_rows - chunk_rows % WORD_ROWS, WORD_ROWS)
            chunks = external_sorted_chunks(
                rows, chunk_rows, order, spill_dir=spill_dir,
                stats=sort_stats, remaps=remaps)
            index = _build_from_chunks(chunks, cards, k, allocation, part,
                                       names, container=container,
                                       remaps=remaps)
            return cls(index, names, dir_path=None, sort_order=order,
                       cards=cards, k=k, allocation=allocation,
                       partition_rows=part, container=container,
                       layout=decision, device=device)

        if order is not None:
            perm = external_merge_sort_perm(rows, chunk_rows, order,
                                            stats=sort_stats, remaps=remaps)
            table = rows[perm]
        else:
            perm, table = None, rows
        if measures is not None and perm is not None:
            # the sidecar rides the same permutation as the fact rows
            measures = {name: arr[perm] for name, arr in measures.items()}
        index = _build_from_chunks(
            (table[s:s + chunk_rows] for s in range(0, max(n, 1), chunk_rows)),
            cards, k, allocation, partition_rows, names,
            container=container, remaps=remaps, measures=measures)
        return cls(index, names, table=table, row_perm=perm,
                   sort_order=order, cards=cards, k=k,
                   allocation=allocation, partition_rows=partition_rows,
                   container=container, layout=decision, device=device)

    @classmethod
    def from_chunks(cls, chunks: Iterable[np.ndarray],
                    columns: Optional[Sequence[str]] = None, *,
                    cards: Optional[Sequence[int]] = None,
                    spill_dir: Optional[str] = None,
                    **kwargs) -> "Dataset":
        """Build from an iterator of row chunks of unknown total size.

        With ``spill_dir`` the incoming chunks are appended to a flat file
        and reopened as a memmap — the sort's random-access input — so the
        raw table is never resident; without it the chunks are concatenated
        in memory.  Everything else (``sort``, ``k``, ``device``, ...)
        behaves exactly like ``from_rows``.

        On the spilled path the layout advisor runs *streaming*: a
        ``LayoutStats`` collector observes each chunk as it is appended to
        the spill file, and the sort column order (plus the frequency
        remaps when ``remap=True``) is frozen from those statistics before
        the external-merge sort starts — the same order the materialized
        ``from_rows`` path would pick, decided without a second pass over
        the memmap and without holding any rows beyond one chunk.
        """
        resolve_device(kwargs.get("device", "cuda"))
        it = iter(chunks)
        if spill_dir is None:
            buf = [np.atleast_2d(np.asarray(c)) for c in it if len(c)]
            if not buf:
                raise ValueError("from_chunks got no rows")
            table = np.concatenate(buf, axis=0)
            return cls.from_rows(table, columns, cards=cards, **kwargs)
        if kwargs.get("measures") is not None:
            raise ValueError(
                "measures are not supported with spill_dir builds")
        os.makedirs(spill_dir, exist_ok=True)
        path = os.path.join(spill_dir, "input-rows.i64")
        n = d = 0
        stats = LayoutStats()
        with open(path, "wb") as f:
            for c in it:
                c = np.atleast_2d(np.asarray(c))
                if not len(c):
                    continue
                if d == 0:
                    d = c.shape[1]
                elif c.shape[1] != d:
                    raise ValueError(
                        f"chunk has {c.shape[1]} columns, expected {d}")
                stats.observe(c)
                np.ascontiguousarray(c, dtype=np.int64).tofile(f)
                n += len(c)
        if n == 0:
            raise ValueError("from_chunks got no rows")
        table = np.memmap(path, dtype=np.int64, mode="r", shape=(n, d))
        if kwargs.get("layout") is None:
            # freeze the advisor's decision from the streaming statistics
            # (cards from the stream when not pinned) — from_rows then
            # never rescans the memmap for cards/order/histograms
            cards = list(cards) if cards is not None else stats.cards()
            kwargs["layout"] = stats.decision(
                sort=kwargs.get("sort", "lex"),
                remap=bool(kwargs.get("remap", False)), cards=cards)
        return cls.from_rows(table, columns, cards=cards,
                             spill_dir=spill_dir, **kwargs)

    @staticmethod
    def _resolve_sort(sort, rows, cards, d) -> Optional[List[int]]:
        if isinstance(sort, str):
            if sort == "none":
                return None
            if sort == "lex":
                return order_columns_freq_aware(rows, cards)
            raise ValueError(
                f"sort must be 'lex', 'none' or a column order, got {sort!r}")
        order = [int(c) for c in sort]
        if sorted(order) != list(range(d)):
            raise ValueError(
                f"explicit sort order {order} is not a permutation of "
                f"range({d})")
        return order

    # -- not in this package yet ---------------------------------------------
    def save(self, dir_path: str) -> "Dataset":
        raise _not_ported("Dataset.save", "item 9 (core/store.py)")

    @classmethod
    def open(cls, dir_path: str, *args, **kwargs) -> "Dataset":
        raise _not_ported("Dataset.open", "item 9 (core/store.py)")

    def append(self, rows) -> int:
        raise _not_ported("Dataset.append",
                          "item 10 (core/wal.py, core/ingest.py)")

    def delete(self, where: Expr) -> int:
        raise _not_ported("Dataset.delete",
                          "item 10 (core/wal.py, core/ingest.py)")

    def compact(self, relayout: bool = False) -> Dict:
        raise _not_ported("Dataset.compact",
                          "item 10 (core/wal.py, core/ingest.py)")

    def shard(self, n_shards: int) -> "Dataset":
        raise _not_ported("Dataset.shard", "item 10 (core/shard.py)")

    def optimize(self, *args, **kwargs) -> Dict:
        raise _not_ported("Dataset.optimize",
                          "items 9-10 (core/store.py, core/ingest.py)")

    def serve(self, **service_kwargs):
        raise _not_ported("Dataset.serve",
                          "item 11 (serve/query_api.py)")

    # -- stats --------------------------------------------------------------
    @property
    def n_rows(self) -> int:
        return self.index.n_rows

    @property
    def n_columns(self) -> int:
        return len(self.index.columns)

    @property
    def n_shards(self) -> int:
        return 1

    @property
    def size_words(self) -> int:
        return self.index.size_words

    def card(self, col) -> int:
        return self.index.card(self.index.resolve_column(col))

    @property
    def measure_names(self) -> List[str]:
        """Declared measure columns, in declaration order."""
        return self.index.measure_names

    # -- querying -----------------------------------------------------------
    def query(self, backend: str = "auto") -> "Query":
        """Start a statement: ``.where(expr)`` narrows it, a terminal
        (``count`` / ``group_by(...).count`` / ``top_k`` / ``rows``)
        executes it on the dataset's device."""
        return Query(self.index, backend=backend, device=self.device)

    def explain(self, e: Expr) -> str:
        from .planner import explain, plan
        head = f"{self._layout.describe()}\n" if self._layout is not None \
            else ""
        return head + explain(plan(self.index, e))


def _build_from_chunks(chunks: Iterable[np.ndarray],
                       cards: Sequence[int], k: int, allocation: str,
                       partition_rows: Optional[int],
                       names: Optional[Sequence[str]],
                       container: str = "run",
                       remaps: Optional[Sequence] = None,
                       measures: Optional[Dict] = None) -> BitmapIndex:
    """Stream row chunks into one monolithic index; ``measures`` (flat
    arrays in the chunks' row order) attach to the result."""
    b = IndexBuilder(cards, k=k, allocation=allocation,
                     partition_rows=partition_rows, column_names=names,
                     container=container, remaps=remaps)
    for chunk in chunks:
        b.append(chunk)
    index = b.finish()
    if measures:
        index.measures = dict(measures)
    return index


class Query:
    """Immutable statement builder over a (monolithic) index.

    ``where`` AND-composes filters and returns a new ``Query``; terminal
    methods execute.  Aggregate terminals stay in the compressed domain end
    to end (see module docstring); ``rows`` is the only terminal that
    materializes row ids.
    """

    __slots__ = ("_index", "_where", "_backend", "_device")

    def __init__(self, index: BitmapIndex, where: Optional[Expr] = None,
                 backend: str = "auto", device: Device = "cuda"):
        self._index = index
        self._where = where
        self._backend = backend
        self._device = resolve_device(device)

    def where(self, e: Expr) -> "Query":
        if not isinstance(e, Expr):
            raise TypeError(f"where() takes an Expr, got {e!r}")
        combined = e if self._where is None else (self._where & e)
        return Query(self._index, combined, self._backend, self._device)

    @property
    def expr(self) -> Optional[Expr]:
        return self._where

    # -- terminals ----------------------------------------------------------
    def count(self) -> int:
        """COUNT(*): memoized compressed-domain popcount — no result
        bitmap, no row ids."""
        from .executor import execute_count
        return execute_count(self._index, self._where,
                             backend=self._backend, device=self._device)

    def group_by(self, col, *more) -> "GroupedQuery":
        """GROUP BY one or two columns; two-column grouping aggregates
        into a ``(card_a, card_b)`` matrix, still entirely in the
        compressed domain (pairwise interval intersection)."""
        return GroupedQuery(self, col, *more)

    # -- measure aggregates --------------------------------------------------
    def agg(self, measure) -> Tuple:
        """Raw ``(sum, count, min, max)`` of ``measure`` under the filter,
        computed by slicing the measure sidecar with the filter's run
        intervals — no row ids, no row reconstruction.  ``min``/``max``
        are ``None`` when no row matches."""
        from .executor import execute_agg
        return execute_agg(self._index, measure, self._where,
                           backend=self._backend, device=self._device)

    def sum(self, measure):
        from .measures import finalize_scalar
        return finalize_scalar("sum", self.agg(measure))

    def avg(self, measure):
        """Mean of ``measure`` over matching rows (``None`` if none match).
        The division happens here, at the very top — shards and workers
        only ever merge exact (sum, count) partials."""
        from .measures import finalize_scalar
        return finalize_scalar("avg", self.agg(measure))

    def min(self, measure):
        from .measures import finalize_scalar
        return finalize_scalar("min", self.agg(measure))

    def max(self, measure):
        from .measures import finalize_scalar
        return finalize_scalar("max", self.agg(measure))

    def top_k(self, col, k: int, measure=None) -> List[Tuple]:
        """The ``k`` heaviest value ranks of ``col`` under the filter —
        by row count (default) or by ``sum(measure)`` — as ``[(value_rank,
        weight), ...]`` sorted by descending weight, ties by ascending
        rank; values with no matching rows never appear."""
        from .executor import execute_group_agg
        if measure is None:
            return top_k_from_counts(self.group_by(col).count(), k)
        agg = execute_group_agg(self._index, measure, [col], self._where,
                                backend=self._backend,
                                device=self._device)
        return top_k_from_values(agg["sums"], agg["counts"], k)

    def rows(self, limit: Optional[int] = None) -> np.ndarray:
        """Matching row ids (sorted); the one terminal that decompresses.

        With ``limit`` the decode itself is truncated: set-bit intervals
        are walked only until ``limit`` ids are covered, so a small preview
        of a huge result is O(limit), never O(result)."""
        from .executor import execute
        from .expr import Const
        e = self._where if self._where is not None else Const(True)
        bm = execute(self._index, e, backend=self._backend,
                     device=self._device)
        if limit is None:
            return bm.set_bits()
        limit = max(int(limit), 0)
        out: List[np.ndarray] = []
        got = 0
        for s, t in zip(*bm.set_intervals()):
            take = min(int(t - s), limit - got)
            out.append(np.arange(s, s + take, dtype=np.int64))
            got += take
            if got >= limit:
                break
        return np.concatenate(out) if out else np.empty(0, np.int64)

    def bitmap(self):
        """The filter's EWAH result bitmap (compressed)."""
        from .executor import execute
        from .expr import Const
        e = self._where if self._where is not None else Const(True)
        return execute(self._index, e, backend=self._backend,
                       device=self._device)

    def explain(self) -> str:
        """Plan tree of the current filter."""
        from .planner import Planner, explain
        planner = Planner(self._index)
        node = planner.plan(self._where) if self._where is not None \
            else planner.plan_count(None)
        return explain(node)


class GroupedQuery:
    """``query().group_by(a[, b])`` — aggregate terminals over one or two
    grouping columns.

    One column keeps the historical shapes (``count()`` is the
    ``np.bincount``-shaped vector); two columns return ``(card_a,
    card_b)`` matrices.  All terminals stay in the compressed domain: the
    shared filter evaluates once, each grouping column's value bitmaps
    intersect it by run-interval arithmetic, and measure statistics come
    from slicing the measure sidecar over the filtered coordinates.
    """

    __slots__ = ("_query", "_cols")

    def __init__(self, query: Query, col, *more):
        if len(more) > 1:
            raise ValueError(
                f"group_by supports at most two columns, got {1 + len(more)}")
        self._query = query
        self._cols = (col,) + more

    @property
    def _col(self):  # backward-compatible single-column accessor
        return self._cols[0]

    def _shape(self, agg: Dict) -> Tuple[int, ...]:
        return tuple(int(s) for s in agg["shape"])

    def count(self) -> np.ndarray:
        """Per-group row counts under the query's filter: an int64 vector
        of length ``card(col)`` (one column, bit-identical to
        ``np.bincount`` over the matching rows) or a ``(card_a, card_b)``
        matrix (two columns) — computed from the bitmaps alone."""
        q = self._query
        if len(self._cols) == 1:
            from .executor import execute_group_count
            return execute_group_count(q._index, self._cols[0], q._where,
                                       backend=q._backend, device=q._device)
        agg = self.agg(None)
        return agg["counts"].reshape(self._shape(agg))

    def agg(self, measure) -> Dict:
        """The raw mergeable partial: ``{"cols", "shape", "counts", and —
        with a measure — "sums", "mins", "maxs"}`` (flat arrays; reshape
        by ``shape``).  The building block behind the named terminals."""
        from .executor import execute_group_agg
        q = self._query
        return execute_group_agg(q._index, measure, list(self._cols),
                                 q._where, backend=q._backend,
                                 device=q._device)

    def _finalized(self, op: str, measure) -> np.ndarray:
        from .measures import finalize_group
        agg = self.agg(measure)
        return finalize_group(op, agg).reshape(self._shape(agg))

    def sum(self, measure) -> np.ndarray:
        """Per-group sums of ``measure`` (measure-dtype array; empty
        groups are 0)."""
        return self._finalized("sum", measure)

    def avg(self, measure) -> np.ndarray:
        """Per-group means (float64; empty groups are NaN)."""
        return self._finalized("avg", measure)

    def min(self, measure) -> np.ndarray:
        """Per-group minima (float64; empty groups are NaN)."""
        return self._finalized("min", measure)

    def max(self, measure) -> np.ndarray:
        """Per-group maxima (float64; empty groups are NaN)."""
        return self._finalized("max", measure)

    def top(self, k: int, measure=None) -> List[Tuple]:
        if len(self._cols) != 1:
            raise ValueError("top(k) needs a single grouping column")
        return self._query.top_k(self._cols[0], k, measure=measure)
