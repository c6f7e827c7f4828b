"""``Dataset``: the one-object façade over the whole fact-table lifecycle.

The paper's pipeline — order columns, sort the fact table, build k-of-N
EWAH bitmap indexes, query them — used to be hand-wired from five modules
(``sorting`` → ``IndexBuilder`` → ``store`` → ``ShardedIndex`` →
``QueryService``).  ``Dataset`` owns that composition end to end while
every piece stays importable for power users:

    from repro_torch.core import Dataset, col

    ds = Dataset.from_rows(table, columns=["region", "day", "user"],
                           sort="lex", shards=4)  # device="cuda" by default
    ds.save("/data/idx")                      # durable per-shard store files
    ds = Dataset.open("/data/idx")            # zero-copy mmap warm start

    q = ds.query().where(col("region") == 3)
    q.count()                                 #   compressed-domain popcount
    q.group_by("day").count()                 #   np.bincount-shaped vector
    q.top_k("day", 5)                         #   [(value_rank, count), ...]
    q.rows(limit=100)                         #   row ids, when you want rows
    svc = ds.serve()                          # pooled, caching QueryService

The dataset's ``device`` is where the executor's kernel path runs and where
its dense operands stay cached (``"cuda"`` unless the caller passes
``"cpu"``; there is no fallback).  The store knows nothing of devices: a
reopened dataset runs on the ``device`` given to ``open``, each shard with
its own operand cache.  ``serve()`` hands the dataset's device on to the
``QueryService``.

Statements, not just filters: ``query()`` returns a small immutable builder
whose terminal methods compile to aggregation plan nodes (``PCount`` /
``PAgg`` / ``PGroupAgg``) evaluated **in the compressed domain** — counts
are memoized EWAH popcounts, a group-by probes each grouping column's run
catalog with the filter's run intervals, and on a sharded index every
shard returns a partial count (vector) that the coordinator sums.  No
aggregate ever materializes a global result bitmap, mirroring how
Lemire/Kaser/Aouiche and the Roaring line evaluate aggregate workloads over
attribute-value bitmaps without decompressing.

Out-of-core builds: ``from_rows(..., spill_dir=...)`` streams chunk-sorted
runs to disk, merges them back in bounded windows and feeds the index
builder chunk by chunk (full-sort compression, O(chunk + partition)
memory); ``from_chunks`` accepts a chunk iterator whose total size is
unknown up front.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

import torch

from repro_torch.kernels import _trace
from repro_torch.kernels.ops import resolve_device
from .expr import Expr
from .index import WORD_ROWS, BitmapIndex, IndexBuilder
from .layout import LayoutDecision, LayoutStats
from .shard import ShardedIndex
from .sorting import (SortStats, external_merge_sort_perm,
                      external_sorted_chunks, order_columns_freq_aware)

DEFAULT_CHUNK_ROWS = 8192

AnyIndex = Union[BitmapIndex, ShardedIndex]
Device = Union[str, torch.device]


def _aligned_rows(n: int, parts: int) -> int:
    """Rows per slice for ``parts`` row-slices of ``n`` rows, rounded up to
    the 32-bit word quantum so interior shards stay concatenation-exact."""
    r = -(-max(n, 1) // max(parts, 1))
    return max(-(-r // WORD_ROWS) * WORD_ROWS, WORD_ROWS)


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

    Build with ``from_rows`` / ``from_chunks``, reopen with ``open``;
    construct directly only to wrap an index you already have (for
    instance one carried over with ``index_from_numpy``).  The sorted
    table is retained on in-memory builds (it feeds ``shard()`` re-slicing
    and the pipeline's row-permutation bookkeeping) and absent on spilled
    builds and store-opened datasets, where rows never lived in memory.
    """

    def __init__(self, index: AnyIndex,
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
        table is *not* retained.  ``shards > 0`` cuts the sorted rows into
        that many word-aligned row shards (the scale-out unit);
        ``cards`` pins global cardinalities when ``rows`` may not contain
        every value.  ``container`` is ``"run"`` (plain word-aligned
        run-list bitmaps), ``"auto"`` (Roaring-style per-chunk containers
        where the cost model says they pay off), or ``None`` to pick by
        sort: sorted builds stay pure run-list (their bitmaps are runs
        already), unsorted ``sort="none"`` builds use ``"auto"``.

        ``measures`` declares numeric *measure columns* (``{name: 1-D
        int/float array}``, one value per input row): they are permuted by
        the same sort as the rows, sliced along the same shard cuts, and
        persisted as the store's zero-copy sidecar — the data behind
        ``query().sum("sales")`` and friends.  Integer measures become
        int64, floating ones float64.  Spilled builds (``spill_dir``) do
        not support measures (the row permutation never materializes).

        ``remap=True`` additionally applies histogram-aware value
        remapping (``repro_torch.core.layout``): a streaming pass collects
        per-column value histograms, frequent values get adjacent encoded
        ranks, and the sort + encoders both use the remapped ranks — runs
        get longer, query results stay in original ranks.  ``layout``
        short-circuits both: a pre-frozen ``LayoutDecision`` (e.g. from
        ``from_chunks``'s streaming collector or ``optimize``) is obeyed
        verbatim and no statistics pass runs here.

        ``device`` is where queries run the kernel path (``"cuda"`` by
        default; raises, before any work, when CUDA is absent).

        Spans (``kernels._trace``, off unless recording): ``build.sort``
        (the column order, then the external merge and the permutation of
        rows and measures), ``build.shard`` (the word-aligned cuts) and the
        builders' ``build.encode`` and ``build.index``, each with its
        ``rows``.  On the spilled path the merge streams into the builders,
        so its time falls in ``build.shard`` or, unsharded, in none.
        """
        device = resolve_device(device)
        rows = np.asarray(rows)
        if rows.ndim != 2:
            raise ValueError(f"rows must be 2-D, got shape {rows.shape}")
        n, d = rows.shape
        if columns is not None and len(columns) != d:
            raise ValueError(
                f"columns has {len(columns)} names for {d} columns")
        with _trace.span("build.sort", rows=n):
            if layout is not None:
                decision = layout
                cards = list(decision.cards) if decision.cards is not None \
                    else (list(cards) if cards is not None
                          else _table_cards(rows))
                order = list(decision.order) if decision.order is not None \
                    else None
            else:
                cards = list(cards) if cards is not None \
                    else _table_cards(rows)
                if remap:
                    stats = LayoutStats()
                    for s in range(0, max(n, 1), chunk_rows):
                        stats.observe(rows[s:s + chunk_rows])
                    decision = stats.decision(sort=sort, remap=True,
                                              cards=cards)
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
            index = _build_from_chunks(chunks, n, cards, k, allocation,
                                       shards, part, names,
                                       container=container, remaps=remaps)
            return cls(index, names, dir_path=None, sort_order=order,
                       cards=cards, k=k, allocation=allocation,
                       partition_rows=part, container=container,
                       layout=decision, device=device)

        if order is not None:
            with _trace.span("build.sort", rows=n):
                perm = external_merge_sort_perm(rows, chunk_rows, order,
                                                stats=sort_stats,
                                                remaps=remaps)
                table = rows[perm]
                if measures is not None:
                    # the sidecar rides the same permutation as the rows
                    measures = {name: arr[perm]
                                for name, arr in measures.items()}
        else:
            perm, table = None, rows
        index = _build_from_chunks(
            (table[s:s + chunk_rows] for s in range(0, max(n, 1), chunk_rows)),
            n, cards, k, allocation, shards, partition_rows, names,
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
        in memory.  Everything else (``sort``, ``k``, ``shards``,
        ``device``, ...) behaves exactly like ``from_rows``.

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

    # -- durability ---------------------------------------------------------
    def save(self, dir_path: str) -> "Dataset":
        """Persist as a sharded store directory (atomic per-shard files +
        manifest carrying the build recipe); returns self, now bound to the
        directory so ``serve()`` warm-starts from it."""
        from .ingest import LiveIndex
        index = self.index
        if isinstance(index, LiveIndex):
            if index.pending_rows:
                raise RuntimeError(
                    "save() on a live dataset with pending mutations — "
                    "compact() first so the base reflects the live rows")
            index = index.base
        if not isinstance(index, ShardedIndex):
            index = ShardedIndex([index])
        index.save(dir_path, meta=self._recipe_meta())
        self.dir_path = dir_path
        return self

    def _recipe_meta(self) -> Dict:
        """The manifest ``meta`` block: build recipe + layout provenance."""
        return {
            "sort_order": self.sort_order,
            "cards": self._cards,
            "k": self._k,
            "allocation": self._allocation,
            "partition_rows": self._partition_rows,
            "layout": self._layout.to_meta() if self._layout is not None
            else None,
        }

    @classmethod
    def open(cls, dir_path: str, mmap: bool = True,
             verify: Optional[bool] = None,
             live: Optional[bool] = None,
             device: Device = "cuda") -> "Dataset":
        """Warm start: reopen a saved dataset as zero-copy memmap views.

        Open cost is metadata-only; bitmap pages fault in as queries touch
        them.  The manifest's build recipe (sort order, cards, encoding)
        is restored so ``explain``/``shard`` diagnostics stay meaningful.

        ``live=True`` attaches the WAL-backed mutable layer immediately;
        ``live=None`` (default) attaches it automatically when the manifest
        names a write-ahead log that exists on disk (i.e. the dataset was
        served live before — possibly with unreplayed mutations from a
        crash); ``live=False`` opens read-only regardless.

        ``device`` is where the reopened dataset's queries run the kernel
        path — the store itself is device-free; it raises before any work
        when it names CUDA and CUDA is absent.
        """
        from . import store
        device = resolve_device(device)
        index: AnyIndex = ShardedIndex.load(dir_path, mmap=mmap,
                                            verify=verify)
        meta = store.manifest_meta(dir_path)
        ds = cls(index, index.column_names, dir_path=dir_path,
                 sort_order=meta.get("sort_order"),
                 cards=meta.get("cards"),
                 k=int(meta.get("k", 1)),
                 allocation=meta.get("allocation", "alpha"),
                 partition_rows=meta.get("partition_rows"),
                 layout=LayoutDecision.from_meta(meta.get("layout")),
                 device=device)
        if live is None:
            wal_name = meta.get("wal") \
                or f"wal-{int(meta.get('epoch', 0)):05d}.log"
            live = os.path.exists(os.path.join(dir_path, wal_name))
        if live:
            ds._ensure_live()
        return ds

    # -- mutation (live ingest) ----------------------------------------------
    def _ensure_live(self):
        """Wrap the index in the WAL-backed mutable layer on first mutation.

        Store-bound datasets get a durable WAL next to the shard files
        (replayed on ``open``); purely in-memory datasets get an
        in-memory delta with no log.  The retained table (if any) is
        dropped — it describes only the immutable base from here on.
        """
        from .ingest import LiveIndex
        if isinstance(self.index, LiveIndex):
            return self.index
        self.index = LiveIndex(
            self.index, dir_path=self.dir_path,
            recipe={"sort_order": self.sort_order,
                    "k": self._k, "allocation": self._allocation,
                    "partition_rows": self._partition_rows,
                    "layout": self._layout.to_meta()
                    if self._layout is not None else None},
            device=self.device)
        self.table = None
        self.row_perm = None
        return self.index

    def append(self, rows) -> int:
        """Durably append rows (value ranks, one array row per fact row).

        The batch is WAL-framed before it is indexed; queries see the new
        rows immediately through the base ⊔ delta merge."""
        return self._ensure_live().append(rows)

    def delete(self, where: Expr) -> int:
        """Durably delete every row matching ``where``; returns how many.

        Evaluated in the compressed domain into per-shard tombstone
        bitmaps — no shard file is rewritten until compaction."""
        return self._ensure_live().delete(where)

    def compact(self, relayout: bool = False) -> Dict:
        """Fold pending mutations into a freshly sorted base (and, when
        store-bound, new shard files + a truncated WAL).  ``relayout=True``
        re-runs the layout advisor over the merged rows first (see
        ``LiveIndex.compact``).  Returns the compaction info dict."""
        info = self._ensure_live().compact(relayout=relayout)
        if relayout:
            # the live layer's recipe now carries the advisor's new choice
            rec = self.index.recipe
            self.sort_order = rec.get("sort_order")
            self._layout = LayoutDecision.from_meta(rec.get("layout"))
        return info

    # -- reshaping ----------------------------------------------------------
    def shard(self, n_shards: int) -> "Dataset":
        """Re-cut the dataset into ``n_shards`` row shards (a new Dataset).

        In-memory builds re-index from the retained sorted table.  Datasets
        opened from a store (or spilled builds) are re-cut directly from
        the compressed index: each column bitmap is sliced at the 32-bit
        word boundaries of the new shard grid (``ShardedIndex.reshard``),
        so the rows are never reconstructed.  Live datasets must be
        compacted first (the delta and tombstones belong to the old grid).
        """
        from .ingest import LiveIndex
        idx = self.index
        if isinstance(idx, LiveIndex):
            if idx.pending_rows:
                raise RuntimeError(
                    "shard() on a live dataset with pending mutations — "
                    "compact() first")
            idx = idx.base
        if self.table is not None:
            index: AnyIndex = _build_from_chunks(
                (self.table[s:s + DEFAULT_CHUNK_ROWS]
                 for s in range(0, max(len(self.table), 1),
                                DEFAULT_CHUNK_ROWS)),
                len(self.table), self._cards or _table_cards(self.table),
                self._k, self._allocation, int(n_shards),
                self._partition_rows, self.column_names,
                container=self._container, remaps=self.remaps,
                measures=_index_measures(idx))
            return Dataset(index, self.column_names, table=self.table,
                           row_perm=self.row_perm, sort_order=self.sort_order,
                           cards=self._cards, k=self._k,
                           allocation=self._allocation,
                           partition_rows=self._partition_rows,
                           container=self._container, layout=self._layout,
                           device=self.device)
        if not isinstance(idx, ShardedIndex):
            idx = ShardedIndex([idx], column_names=self.column_names)
        return Dataset(idx.reshard(int(n_shards)), self.column_names,
                       sort_order=self.sort_order, cards=self._cards,
                       k=self._k, allocation=self._allocation,
                       partition_rows=self._partition_rows,
                       layout=self._layout, device=self.device)

    def optimize(self, col_order: Union[str, Sequence[int]] = "auto",
                 remap: bool = True, *,
                 spill_dir: Optional[str] = None,
                 chunk_rows: int = DEFAULT_CHUNK_ROWS,
                 sort_stats: Optional[SortStats] = None,
                 shards: Optional[int] = None) -> Dict:
        """Re-sort an existing dataset into the advisor's physical layout.

        Reconstructs the rows shard by shard from the compressed bitmaps
        (never more than one shard of rows resident), streams them through
        the layout advisor + external-merge sort + index builders exactly
        like a fresh build, and adopts the result in place.  On a
        store-backed dataset the new shard files land under an
        ``oNNNNN-`` prefix and the manifest rewrite is the atomic cutover
        (the same path live-ingest compaction uses): a crash mid-optimize
        leaves the old manifest naming the old, untouched files, and
        concurrent readers holding mmaps keep serving the old inodes.

        ``col_order`` is ``"auto"`` (re-run the §4.3 advisor), an explicit
        column order, or ``"none"``; ``remap`` re-derives the per-column
        frequency remaps from fresh histograms.  Query results are
        unchanged — only row order and value encoding move.  Returns an
        info dict with before/after sizes and the adopted layout.
        """
        from .ingest import LiveIndex
        from . import store as store_mod
        idx = self.index
        was_live = isinstance(idx, LiveIndex)
        if was_live:
            if idx.pending_rows:
                raise RuntimeError(
                    "optimize() on a live dataset with pending mutations — "
                    "compact() first so the base reflects the live rows")
            old_live, idx = idx, idx.base
        if not idx.n_rows:
            raise ValueError("optimize() on an empty dataset")
        measures = _index_measures(idx)
        if measures and spill_dir is not None:
            raise ValueError(
                "optimize(spill_dir=...) is not supported on a "
                "measure-bearing dataset: the re-sort permutation never "
                "materializes out-of-core, so the sidecar could not follow")
        size_before = idx.size_words
        n_shards = int(shards) if shards is not None \
            else getattr(idx, "n_shards", 1)
        sort = "lex" if (isinstance(col_order, str) and col_order == "auto") \
            else col_order

        def _chunks():
            for sh in (idx.shards if isinstance(idx, ShardedIndex)
                       else [idx]):
                if not sh.n_rows:
                    continue
                t = sh.reconstruct_rows()
                for s in range(0, len(t), chunk_rows):
                    yield t[s:s + chunk_rows]

        new = Dataset.from_chunks(
            _chunks(), self.column_names, cards=self._cards,
            spill_dir=spill_dir, sort=sort, remap=remap,
            k=self._k, allocation=self._allocation,
            shards=n_shards if n_shards > 1 else 0,
            partition_rows=self._partition_rows, chunk_rows=chunk_rows,
            sort_stats=sort_stats, device=self.device)
        if measures:
            # the reconstructed chunks streamed in the old row order; the
            # rebuild's sort permutation maps it onto the new order, and
            # the sidecar follows it just like a fresh from_rows build
            perm = new.row_perm
            _attach_measures(new.index,
                             {name: (arr[perm] if perm is not None else arr)
                              for name, arr in measures.items()})
        # adopt the rebuilt layout in place
        self.sort_order = new.sort_order
        self._cards = new._cards
        self._layout = new._layout
        self._container = new._container
        self.row_perm = None  # permutations are relative to the old order
        info: Dict = {"n_rows": int(new.n_rows),
                      "size_words_before": int(size_before),
                      "order": self.sort_order,
                      "remapped_columns": self._layout.remapped_columns
                      if self._layout is not None else []}
        if was_live:
            old_live.close()
        if self.dir_path is not None:
            meta_old = store_mod.manifest_meta(self.dir_path)
            opt_epoch = int(meta_old.get("opt_epoch", 0)) + 1
            old_files = store_mod.manifest_shards(self.dir_path)
            nidx = new.index if isinstance(new.index, ShardedIndex) \
                else ShardedIndex([new.index],
                                  column_names=self.column_names)
            meta = self._recipe_meta()
            meta["opt_epoch"] = opt_epoch
            # live-ingest provenance (epoch counter, WAL name) survives the
            # layout swap — the WAL is empty here, but its name must keep
            # matching the manifest for the next live open
            for key in ("epoch", "wal"):
                if meta_old.get(key) is not None:
                    meta[key] = meta_old[key]
            # shard files first, manifest rewrite last: the rename IS the
            # cutover (identical to the compaction path)
            store_mod.save_sharded(nidx, self.dir_path, meta=meta,
                                   prefix=f"o{opt_epoch:05d}-")
            keep = set(store_mod.manifest_shards(self.dir_path))
            for name in old_files:
                if name not in keep:
                    try:
                        os.unlink(os.path.join(self.dir_path, name))
                    except OSError:
                        pass
            self.index = ShardedIndex.load(self.dir_path)
            self.table = None
            info["opt_epoch"] = opt_epoch
        else:
            self.index = new.index
            self.table = new.table
        if was_live:
            self._ensure_live()
        info["size_words_after"] = int(self.index.size_words
                                       if not was_live
                                       else self.index.base.size_words)
        return info

    # -- stats --------------------------------------------------------------
    @property
    def n_rows(self) -> int:
        return self.index.n_rows

    @property
    def n_columns(self) -> int:
        idx = self.index
        return len(idx.columns) if isinstance(idx, BitmapIndex) \
            else idx.n_columns

    @property
    def n_shards(self) -> int:
        return getattr(self.index, "n_shards", 1)

    @property
    def size_words(self) -> int:
        return self.index.size_words

    def card(self, col) -> int:
        return self.index.card(self.index.resolve_column(col))

    @property
    def measure_names(self) -> List[str]:
        """Declared measure columns, in declaration order."""
        return list(getattr(self.index, "measure_names", []) or [])

    # -- querying -----------------------------------------------------------
    def query(self, backend: str = "auto") -> "Query":
        """Start a statement: ``.where(expr)`` narrows it, a terminal
        (``count`` / ``group_by(...).count`` / ``top_k`` / ``rows``)
        executes it on the dataset's device."""
        return Query(self.index, backend=backend, device=self.device)

    def explain(self, e: Expr) -> str:
        from .ingest import LiveIndex
        from .planner import explain, plan
        idx = self.index
        if isinstance(idx, LiveIndex):
            idx = idx.base  # the delta layer plans the same tree
        head = f"{self._layout.describe()}\n" if self._layout is not None \
            else ""
        if isinstance(idx, ShardedIndex):
            return (f"{head}per-shard plans x{idx.n_shards}; shard 0:\n"
                    + explain(plan(idx.shards[0], e)))
        return head + explain(plan(idx, e))

    # -- serving ------------------------------------------------------------
    def serve(self, **service_kwargs):
        """A pooled, caching ``QueryService`` over this dataset — warm
        (mmap) when the dataset is bound to a store directory, in-memory
        otherwise — running on the dataset's ``device`` unless the caller
        names another.  Keyword arguments pass through to
        ``QueryService``."""
        from repro_torch.serve.query_api import QueryService
        from .ingest import LiveIndex
        service_kwargs.setdefault("device", self.device)
        if isinstance(self.index, LiveIndex):
            # share the live layer (and its WAL) rather than re-opening
            return QueryService(self.index, index_dir=self.dir_path,
                                **service_kwargs)
        if self.dir_path is not None:
            return QueryService.from_dir(self.dir_path, **service_kwargs)
        return QueryService(self.index, **service_kwargs)


def _attach_measures(index: AnyIndex,
                     measures: Optional[Dict[str, np.ndarray]]) -> None:
    """Attach flat (already row-ordered) measure arrays to an index,
    slicing along the shard cuts when sharded."""
    if not measures:
        return
    if isinstance(index, ShardedIndex):
        off = 0
        for sh in index.shards:
            sh.measures = {name: arr[off:off + sh.n_rows]
                           for name, arr in measures.items()}
            off += sh.n_rows
    else:
        index.measures = dict(measures)


def _index_measures(index: AnyIndex) -> Optional[Dict[str, np.ndarray]]:
    """The index's measure sidecar as flat arrays in global row order
    (concatenating shard slices), or ``None`` when it carries none."""
    if isinstance(index, ShardedIndex):
        if not index.shards[0].measures:
            return None
        return {name: np.concatenate([np.asarray(sh.measures[name])
                                      for sh in index.shards])
                for name in index.shards[0].measures}
    return dict(index.measures) if index.measures else None


def _build_from_chunks(chunks: Iterable[np.ndarray], n_rows: int,
                       cards: Sequence[int], k: int, allocation: str,
                       shards: int, partition_rows: Optional[int],
                       names: Optional[Sequence[str]],
                       container: str = "run",
                       remaps: Optional[Sequence] = None,
                       measures: Optional[Dict] = None) -> AnyIndex:
    """Stream row chunks into one index — monolithic, or cut into
    ``shards`` word-aligned row shards built by independent builders (the
    span ``build.shard``, around the builders' own ``build.encode`` and
    ``build.index``).  ``measures`` (flat arrays in the chunks' row order)
    attach to the result, sliced along the same shard cuts."""
    def builder():
        return IndexBuilder(cards, k=k, allocation=allocation,
                            partition_rows=partition_rows,
                            column_names=names, container=container,
                            remaps=remaps)

    if shards and shards > 1:
        with _trace.span("build.shard", rows=n_rows, shards=shards):
            shard_rows = _aligned_rows(n_rows, shards)
            done: List[BitmapIndex] = []
            cur, filled = builder(), 0
            for chunk in chunks:
                chunk = np.asarray(chunk)
                while len(chunk):
                    take = min(shard_rows - filled, len(chunk))
                    cur.append(chunk[:take])
                    filled += take
                    chunk = chunk[take:]
                    if filled == shard_rows:
                        done.append(cur.finish())
                        cur, filled = builder(), 0
            if filled or not done:
                done.append(cur.finish())
            else:
                cur.abort()
            index: AnyIndex = ShardedIndex(done, column_names=names)
    else:
        b = builder()
        for chunk in chunks:
            b.append(chunk)
        index = b.finish()
    _attach_measures(index, measures)
    return index


class Query:
    """Immutable statement builder over an index (monolithic or sharded).

    ``where`` AND-composes filters and returns a new ``Query``; terminal
    methods execute.  Aggregate terminals stay in the compressed domain end
    to end (see module docstring); ``rows`` is the only terminal that
    materializes row ids.
    """

    __slots__ = ("_index", "_where", "_backend", "_pool", "_device")

    def __init__(self, index: AnyIndex, where: Optional[Expr] = None,
                 backend: str = "auto", pool=None, device: Device = "cuda"):
        self._index = index
        self._where = where
        self._backend = backend
        self._pool = pool
        self._device = resolve_device(device)

    def where(self, e: Expr) -> "Query":
        if not isinstance(e, Expr):
            raise TypeError(f"where() takes an Expr, got {e!r}")
        combined = e if self._where is None else (self._where & e)
        return Query(self._index, combined, self._backend, self._pool,
                     self._device)

    def with_pool(self, pool) -> "Query":
        """Attach a shard worker pool (``concurrent.futures`` executor or
        ``ShardProcessPool``) for shard-parallel execution."""
        return Query(self._index, self._where, self._backend, pool,
                     self._device)

    @property
    def expr(self) -> Optional[Expr]:
        return self._where

    # -- terminals ----------------------------------------------------------
    def count(self) -> int:
        """COUNT(*): memoized compressed-domain popcount; per-shard partial
        counts are summed — no result bitmap, no row ids."""
        from .executor import execute_count
        return execute_count(self._index, self._where,
                             backend=self._backend, pool=self._pool,
                             device=self._device)

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
                           backend=self._backend, pool=self._pool,
                           device=self._device)

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
        rank; values with no matching rows never appear.  On a sharded
        index this runs the shard-pruned (TPUT-style) two-phase protocol;
        ordering is identical to the monolithic path by construction."""
        from .executor import execute_group_agg
        idx = self._index
        if isinstance(idx, ShardedIndex):
            return idx.top_k(col, k, self._where, measure=measure,
                             backend=self._backend, pool=self._pool,
                             device=self._device)
        if measure is None:
            return top_k_from_counts(self.group_by(col).count(), k)
        agg = execute_group_agg(idx, measure, [col], self._where,
                                backend=self._backend, pool=self._pool,
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
        bm = execute(self._index, e, backend=self._backend, pool=self._pool,
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
                       pool=self._pool, device=self._device)

    def explain(self) -> str:
        """Plan tree(s) of the current filter."""
        from .ingest import LiveIndex
        from .planner import Planner, explain
        idx = self._index
        if isinstance(idx, LiveIndex):
            idx = idx.base
        target = idx.shards[0] if isinstance(idx, ShardedIndex) else idx
        planner = Planner(target)
        node = planner.plan(self._where) if self._where is not None \
            else planner.plan_count(None)
        head = (f"per-shard plans x{idx.n_shards}; shard 0:\n"
                if isinstance(idx, ShardedIndex) else "")
        return head + explain(node)


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
        matrix (two columns) — computed from the bitmaps alone, with
        per-shard partial vectors summed at the coordinator."""
        q = self._query
        if len(self._cols) == 1:
            from .executor import execute_group_count
            return execute_group_count(q._index, self._cols[0], q._where,
                                       backend=q._backend, pool=q._pool,
                                       device=q._device)
        agg = self.agg(None)
        return agg["counts"].reshape(self._shape(agg))

    def agg(self, measure) -> Dict:
        """The raw mergeable partial: ``{"cols", "shape", "counts", and —
        with a measure — "sums", "mins", "maxs"}`` (flat arrays; reshape
        by ``shape``).  The building block behind the named terminals."""
        from .executor import execute_group_agg
        q = self._query
        return execute_group_agg(q._index, measure, list(self._cols),
                                 q._where, backend=q._backend, pool=q._pool,
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
