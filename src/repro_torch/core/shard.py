"""Horizontally sharded bitmap index: per-shard planning and execution.

A ``ShardedIndex`` holds a row-range of the fact table per shard, each as an
ordinary ``BitmapIndex`` with its own partitions and compressed-size stats.
Shards share one set of k-of-N encoders (global cardinalities), so bitmap ids
mean the same thing everywhere; queries are planned *per shard* by the
existing planner — operand ordering adapts to each shard's own compressed
sizes — executed by the existing executor, and the per-shard EWAH results are
concatenated exactly (interior shards are validated word-aligned, the same
invariant the paper's 256 MB blocks rely on, one level up).

This is the coarse-grained unit for scale-out: shards can live on different
workers, be built independently by streaming ``IndexBuilder``s, and be
appended/retired without touching their siblings.

Every query method takes the ``device`` its shards' executors run the
kernel path on (``"cuda"`` by default, ``"cpu"`` only when asked for); each
shard is its own ``BitmapIndex`` and so keeps its own cache of dense
operands on that device.

Execution is shard-parallel when a worker pool is supplied (``execute(...,
pool=...)``): shards are embarrassingly independent.  Two pool flavours are
accepted interchangeably — any ``concurrent.futures`` executor (the serving
layer hands down its own thread pool), or a ``ShardProcessPool``, which
forks workers that inherit the shards by copy-on-write so CPU-bound EWAH
work escapes the GIL without ever pickling an index; only the compressed
results cross process boundaries.  Forked workers never touch CUDA: they
run the NumPy EWAH path on the host (see ``ShardProcessPool``), while a
thread pool runs each shard's kernel path from its own thread.  Each shard
also keeps a *shard-local* LRU of its own EWAH results keyed by the
expression's canonical structural key — ``replace_shard`` (a single-shard rebuild) invalidates only that
slice, so the other shards' warm results survive an incremental reindex
(and bumps the index generation, which makes process pools re-fork).
"""
from __future__ import annotations

import itertools
import multiprocessing
import os
import threading
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .ewah import EWAH
from .expr import Expr, canonical_key
from .index import (BitmapIndex, ColumnIndex, IndexBuilder, WORD_ROWS,
                    concat_bitmaps, validate_partition_rows)
from .lru import LRUCache, payload_kind, payload_nbytes

Device = Union[str, torch.device]

# per-shard result-cache defaults (entries + byte budget per shard)
SHARD_CACHE_ENTRIES = 64
SHARD_CACHE_BYTES = 16 << 20


class ShardedIndex:
    """A list of row-contiguous ``BitmapIndex`` shards with offset bookkeeping."""

    def __init__(self, shards: Sequence[BitmapIndex],
                 column_names: Optional[Sequence[str]] = None,
                 cache_entries: int = SHARD_CACHE_ENTRIES,
                 cache_bytes: Optional[int] = SHARD_CACHE_BYTES):
        shards = list(shards)
        if not shards:
            raise ValueError("ShardedIndex needs at least one shard")
        ref = shards[0]
        for i, sh in enumerate(shards):
            self._validate_shard(i, sh, ref, interior=i + 1 < len(shards))
        self.shards = shards
        self.offsets = np.concatenate(
            [[0], np.cumsum([sh.n_rows for sh in shards])]).astype(np.int64)
        names = list(column_names) if column_names is not None \
            else ref.column_names
        self.column_names = names
        self._cache_entries = cache_entries
        self._cache_bytes = cache_bytes
        self._result_caches = [self._new_cache() for _ in shards]
        # bumped on every shard replacement; process pools forked against an
        # older generation re-fork before serving (never a stale shard)
        self.generation = 0

    def _new_cache(self) -> LRUCache:
        return LRUCache(capacity=self._cache_entries,
                        max_bytes=self._cache_bytes,
                        sizeof=payload_nbytes, classify=payload_kind)

    @staticmethod
    def _validate_shard(i: int, sh: BitmapIndex, ref: BitmapIndex,
                        interior: bool) -> None:
        if len(sh.columns) != len(ref.columns):
            raise ValueError(
                f"shard {i} has {len(sh.columns)} columns, expected "
                f"{len(ref.columns)}")
        for c, (a, b) in enumerate(zip(sh.columns, ref.columns)):
            ea, eb = a.encoder, b.encoder
            if (ea.card, ea.k, ea.L) != (eb.card, eb.k, eb.L):
                raise ValueError(
                    f"shard {i} column {c} encoder {ea!r} differs from "
                    f"shard 0's {eb!r}; shards must share global "
                    f"cardinalities")
            same_remap = (ea.remap is None and eb.remap is None) or (
                ea.remap is not None and eb.remap is not None
                and np.array_equal(ea.remap, eb.remap))
            if not same_remap:
                raise ValueError(
                    f"shard {i} column {c} value remap differs from shard "
                    f"0's; shards must share the frequency remap or query "
                    f"results would disagree across shard boundaries")
        ma = sh.measures or {}
        mb = ref.measures or {}
        if sorted(ma) != sorted(mb):
            raise ValueError(
                f"shard {i} declares measures {sorted(ma)}, expected "
                f"{sorted(mb)}; shards must carry identical measure "
                f"sidecars or aggregates would silently drop rows")
        for name in ma:
            da = np.asarray(ma[name]).dtype
            db = np.asarray(mb[name]).dtype
            if da != db:
                raise ValueError(
                    f"shard {i} measure {name!r} dtype {da} differs from "
                    f"shard 0's {db}")
            if len(ma[name]) != sh.n_rows:
                raise ValueError(
                    f"shard {i} measure {name!r} has {len(ma[name])} "
                    f"values for {sh.n_rows} rows")
        if interior and sh.n_rows % WORD_ROWS:
            raise ValueError(
                f"interior shard {i} has {sh.n_rows} rows, not a "
                f"multiple of {WORD_ROWS}; results could not be "
                f"concatenated exactly")

    @classmethod
    def build(
        cls,
        table: np.ndarray,
        shard_rows: int,
        k: int = 1,
        allocation: str = "alpha",
        cards: Optional[Sequence[int]] = None,
        partition_rows: Optional[int] = None,
        apply_heuristic: bool = True,
        column_names: Optional[Sequence[str]] = None,
        cache_entries: int = SHARD_CACHE_ENTRIES,
        cache_bytes: Optional[int] = SHARD_CACHE_BYTES,
        measures: Optional[Dict] = None,
    ) -> "ShardedIndex":
        """Cut ``table`` into row shards of ``shard_rows`` and index each.

        Cardinalities are computed globally (unless given) so every shard
        uses identical encoders — a value absent from one shard still owns
        its bitmap there, keeping per-shard plans and results composable.
        ``measures`` (``{name: numeric array}`` aligned with ``table``'s
        rows) is sliced along the same shard cuts.
        """
        table = np.asarray(table)
        n, d = table.shape
        shard_rows = validate_partition_rows(int(shard_rows))
        validate_partition_rows(partition_rows)
        if cards is None:
            cards = [int(table[:, c].max()) + 1 if n else 1 for c in range(d)]
        if measures is not None:
            from .measures import normalize_measures
            measures = normalize_measures(measures, n)
        shards = []
        for s in range(0, n, shard_rows) or [0]:
            builder = IndexBuilder(cards, k=k, allocation=allocation,
                                   partition_rows=partition_rows,
                                   apply_heuristic=apply_heuristic,
                                   column_names=column_names)
            sh = builder.append(table[s:s + shard_rows]).finish()
            if measures is not None:
                sh.measures = {name: arr[s:s + shard_rows]
                               for name, arr in measures.items()}
            shards.append(sh)
        return cls(shards, column_names=column_names,
                   cache_entries=cache_entries, cache_bytes=cache_bytes)

    # -- durability (repro_torch.core.store) ---------------------------------
    def save(self, dir_path: str, meta: Optional[Dict] = None) -> str:
        """Persist as a directory of per-shard store files + manifest.

        Each shard file is written atomically; ``load(dir, mmap=True)``
        reopens the whole index as zero-copy memmap views.  ``meta`` is
        carried verbatim in the manifest (see ``store.save_sharded``)."""
        from .store import save_sharded
        return save_sharded(self, dir_path, meta=meta)

    @classmethod
    def load(cls, dir_path: str, mmap: bool = True,
             verify: Optional[bool] = None,
             cache_entries: int = SHARD_CACHE_ENTRIES,
             cache_bytes: Optional[int] = SHARD_CACHE_BYTES) -> "ShardedIndex":
        """Open a saved sharded index; with ``mmap`` (default) shard bitmaps
        are read-only file views and open time is metadata-only."""
        from .store import load_sharded
        return load_sharded(dir_path, mmap=mmap, verify=verify,
                            cache_entries=cache_entries,
                            cache_bytes=cache_bytes)

    def replace_shard_file(self, dir_path: str, i: int,
                           shard: BitmapIndex) -> str:
        """Atomically rewrite shard ``i``'s store file *and* swap the shard
        in this live index (single-file incremental reindex).

        The shard is validated *before* anything is written: a rejected
        shard must never reach the directory, or the next ``load`` /
        ``/admin/reload`` would pick up data the live index refused.
        """
        from .store import write_shard_file
        if not (0 <= i < len(self.shards)):
            raise IndexError(f"shard {i} out of range [0, {len(self.shards)})")
        ref = self.shards[0] if i else (self.shards[1] if len(self.shards) > 1
                                        else shard)
        self._validate_shard(i, shard, ref, interior=i + 1 < len(self.shards))
        path = write_shard_file(dir_path, i, shard)
        self.replace_shard(i, shard)
        return path

    # -- stats (mirrors BitmapIndex) ---------------------------------------
    @property
    def n_rows(self) -> int:
        return int(self.offsets[-1])

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def n_columns(self) -> int:
        return len(self.shards[0].columns)

    @property
    def size_words(self) -> int:
        return sum(sh.size_words for sh in self.shards)

    @property
    def n_bitmaps(self) -> int:
        return self.shards[0].n_bitmaps

    @property
    def n_partitions(self) -> int:
        return sum(sh.n_partitions for sh in self.shards)

    def card(self, col: int) -> int:
        return self.shards[0].card(col)

    def resolve_column(self, key) -> int:
        if self.column_names is not None and isinstance(key, str):
            try:
                return self.column_names.index(key)
            except ValueError:
                raise KeyError(f"unknown column {key!r}") from None
        return self.shards[0].resolve_column(key)

    def shard_of_row(self, row: int) -> int:
        """Which shard owns global row id ``row``."""
        if not (0 <= row < self.n_rows):
            raise IndexError(f"row {row} out of range [0, {self.n_rows})")
        return int(np.searchsorted(self.offsets, row, side="right")) - 1

    # -- queries -----------------------------------------------------------
    def bitmap(self, col: int, bitmap_id: int) -> EWAH:
        """One physical bitmap concatenated over all shards (and partitions)."""
        return concat_bitmaps([sh.bitmap(col, bitmap_id)
                               for sh in self.shards if sh.n_rows])

    def equality_bitmap(self, col: int, value_rank: int) -> EWAH:
        return concat_bitmaps([sh.equality_bitmap(col, value_rank)
                               for sh in self.shards])

    def equality_rows(self, col: int, value_rank: int) -> np.ndarray:
        return self.equality_bitmap(col, value_rank).set_bits()

    # -- reshaping ----------------------------------------------------------
    def reshard(self, n_shards: int) -> "ShardedIndex":
        """Re-cut into ``n_shards`` word-aligned row shards straight from
        the compressed bitmaps — no retained fact table, no decompression.

        Every bitmap of every new shard is assembled by slicing the source
        partitions' EWAH streams at 32-bit word boundaries
        (``EWAH.slice_bits``): new shard bounds are word multiples and
        source partition starts are word-aligned by construction, so each
        overlap of a new shard with a source partition becomes one
        partition of the new shard, cut run-for-run in the compressed
        domain.  Works on memmap-opened stores too (slices copy out of the
        mapped words); encoders are shared, so the result answers queries
        bit-identically to ``self``.
        """
        n_shards = int(n_shards)
        if n_shards <= 0:
            raise ValueError(f"n_shards must be positive, got {n_shards}")
        n = self.n_rows
        per = -(-max(n, 1) // n_shards)
        shard_rows = max(-(-per // WORD_ROWS) * WORD_ROWS, WORD_ROWS)
        # global (start, end, shard, partition) of every source partition
        spans = []
        for si, sh in enumerate(self.shards):
            off = int(self.offsets[si])
            b = sh.partition_bounds
            for p in range(sh.n_partitions):
                spans.append((off + int(b[p]), off + int(b[p + 1]), si, p))
        encoders = [c.encoder for c in self.shards[0].columns]
        new_shards: List[BitmapIndex] = []
        for s in range(0, max(n, 1), shard_rows):
            e = min(s + shard_rows, n) if n else 0
            overlaps = [(max(s, gs), min(e, ge), si, p)
                        for gs, ge, si, p in spans
                        if gs < e and ge > s]
            bounds = [0]
            cols = [ColumnIndex(encoder=enc, bitmaps=[]) for enc in encoders]
            for lo, hi, si, p in overlaps:
                src = self.shards[si]
                gs = int(self.offsets[si]) \
                    + int(src.partition_bounds[p])
                for c, ci in enumerate(cols):
                    ci.bitmaps.append(
                        [bm.slice_bits(lo - gs, hi - gs)
                         for bm in src.columns[c].bitmaps[p]])
                bounds.append(bounds[-1] + (hi - lo))
            ns = BitmapIndex(
                n_rows=e - s, columns=cols,
                partition_bounds=np.asarray(bounds, dtype=np.int64),
                column_names=self.column_names)
            if self.shards[0].measures:
                # the sidecar re-cuts by plain slicing along the same
                # shard bounds the bitmaps were sliced at
                m: Dict[str, np.ndarray] = {}
                for name in self.shards[0].measures:
                    segs = []
                    for si, src in enumerate(self.shards):
                        o = int(self.offsets[si])
                        lo, hi = max(s, o), min(e, o + src.n_rows)
                        if lo < hi:
                            segs.append(np.asarray(
                                src.measures[name][lo - o:hi - o]))
                    dt = np.asarray(self.shards[0].measures[name]).dtype
                    m[name] = (np.concatenate(segs) if segs
                               else np.empty(0, dtype=dt))
                ns.measures = m
            new_shards.append(ns)
        return ShardedIndex(new_shards, column_names=self.column_names,
                            cache_entries=self._cache_entries,
                            cache_bytes=self._cache_bytes)

    def replace_shard(self, i: int, shard: BitmapIndex) -> None:
        """Swap in a rebuilt shard; only *its* result-cache slice drops.

        The incremental-reindex primitive: sibling shards keep their warm
        cached results, offsets are recomputed (the new shard may have a
        different row count as long as word alignment holds for interior
        shards).
        """
        if not (0 <= i < len(self.shards)):
            raise IndexError(f"shard {i} out of range [0, {len(self.shards)})")
        ref = self.shards[0] if i else (self.shards[1] if len(self.shards) > 1
                                        else shard)
        self._validate_shard(i, shard, ref,
                             interior=i + 1 < len(self.shards))
        self.shards[i] = shard
        self.offsets = np.concatenate(
            [[0], np.cumsum([sh.n_rows for sh in self.shards])]).astype(np.int64)
        self._result_caches[i] = self._new_cache()
        self.generation += 1

    def cache_stats(self) -> List[Dict]:
        return [c.stats() for c in self._result_caches]

    def _fan_out(self, key, run_shard, task, pool,
                 backend: str, optimize: bool) -> List:
        """Shared shard fan-out: per-shard LRU lookup, pool dispatch for the
        misses, cache refill.  Returns one result per shard, in order.

        ``key`` (or ``None`` to skip caching) addresses the shard-local
        LRUs; ``task`` is the picklable statement shipped to a
        ``ShardProcessPool``; ``run_shard(i, shard)`` is the in-process
        fallback, handed the shard object from *this* snapshot.

        Caches are snapshotted *before* shards — in here, so no caller can
        get the order wrong: ``replace_shard`` writes the shard first, then
        installs a fresh cache, so reading in the opposite order means a
        racing replacement can pair an old cache with a new shard — and a
        result computed on a replaced shard then lands in the *retired* LRU
        object, which no future query reads (fresh-cache poisoning is
        impossible in either interleaving).  Process pools execute against
        their forked copy and re-fork on the next generation check;
        whole-result staleness across a mid-query replace is the serving
        layer's generation counter's job.
        """
        rcaches = list(self._result_caches)
        shards = list(self.shards)
        n = len(shards)
        parts: List = [None] * n
        if key is not None:
            for i in range(n):
                parts[i] = rcaches[i].get(key)
        missing = [i for i, p in enumerate(parts) if p is None]
        if isinstance(pool, ShardProcessPool) and len(missing) > 1:
            fresh = pool.run_shards(task, missing, backend=backend,
                                    optimize=optimize)
        elif pool is not None and not isinstance(pool, ShardProcessPool) \
                and len(missing) > 1:
            fresh = list(pool.map(lambda i: run_shard(i, shards[i]), missing))
        else:
            fresh = [run_shard(i, shards[i]) for i in missing]
        for i, res in zip(missing, fresh):
            parts[i] = res
            if key is not None:
                rcaches[i].put(key, res)
        return parts

    def execute(self, e, backend: str = "auto", optimize: bool = True,
                caches: Optional[List[Dict]] = None, pool=None,
                device: Device = "cuda") -> EWAH:
        """Plan per shard, execute per shard, concatenate the EWAH results.

        ``caches`` (one operand dict per shard) lets a batch share loaded
        bitmaps across queries, exactly like ``Executor``'s cache does for a
        monolithic index.  ``pool`` (any ``concurrent.futures`` executor)
        runs shards concurrently; shard tasks submit no further work, so a
        dedicated pool is deadlock-free by construction.  Per-shard results
        of ``Expr`` queries are memoized in the shard-local LRU keyed by
        ``canonical_key`` — a repeat (or commutatively reordered) query only
        re-executes shards whose cache was invalidated.
        """
        return concat_bitmaps(self.execute_per_shard(
            e, backend=backend, optimize=optimize, caches=caches, pool=pool,
            device=device))

    def execute_per_shard(self, e, backend: str = "auto",
                          optimize: bool = True,
                          caches: Optional[List[Dict]] = None,
                          pool=None, device: Device = "cuda") -> List[EWAH]:
        """Per-shard EWAH results of one expression, in shard order.

        The fan-out behind ``execute``, exposed separately for callers that
        need the un-concatenated slices — the live-ingest layer pairs each
        shard's result with that shard's tombstone before merging, so the
        shard-local LRU entries (keyed by the expression alone) stay valid
        across tombstone changes.
        """
        from .executor import Executor  # local: executor also dispatches here
        from .planner import plan
        key = (("expr", backend, bool(optimize), canonical_key(e))
               if isinstance(e, Expr) else None)

        def run_shard(i: int, sh: BitmapIndex) -> EWAH:
            node = plan(sh, e, optimize=optimize) if isinstance(e, Expr) else e
            cache = caches[i] if caches is not None else None
            return Executor(sh, backend=backend, cache=cache,
                            device=device).run(node)

        return self._fan_out(key, run_shard, ("expr", e), pool,
                             backend, optimize)

    def count(self, e=None, backend: str = "auto", optimize: bool = True,
              caches: Optional[List[Dict]] = None, pool=None,
              device: Device = "cuda") -> int:
        """COUNT(*) under filter ``e`` (``None`` counts every row).

        Each shard plans and popcounts its own slice in the compressed
        domain; the coordinator *sums the integers* — no per-shard result
        bitmap is ever concatenated for an aggregate.
        """
        from .executor import Executor
        from .planner import Planner
        if e is not None and not isinstance(e, Expr):
            raise TypeError(f"count() takes an Expr or None, got {e!r}")
        key = ("count", backend, bool(optimize),
               canonical_key(e) if e is not None else None)

        def run_shard(i: int, sh: BitmapIndex) -> int:
            node = Planner(sh, optimize=optimize).plan_count(e)
            cache = caches[i] if caches is not None else None
            return Executor(sh, backend=backend, cache=cache,
                            device=device).run_count(node)

        parts = self._fan_out(key, run_shard, ("count", e), pool,
                              backend, optimize)
        return int(sum(parts))

    def group_count(self, col, e=None, backend: str = "auto",
                    optimize: bool = True,
                    caches: Optional[List[Dict]] = None,
                    pool=None, device: Device = "cuda") -> np.ndarray:
        """GROUP BY ``col`` COUNT(*) under filter ``e`` -> int64 vector of
        length ``card(col)``.

        The shards share one set of encoders, so every shard produces a
        count vector in the same value-rank space; the coordinator merges
        by *summing the partial vectors* (scatter/gather aggregation — the
        global result bitmap that ``execute`` would concatenate never
        exists here).
        """
        from .executor import Executor
        from .planner import Planner
        if e is not None and not isinstance(e, Expr):
            raise TypeError(f"group_count() takes an Expr or None, got {e!r}")
        c = self.resolve_column(col)
        key = ("gcount", c, backend, bool(optimize),
               canonical_key(e) if e is not None else None)

        def run_shard(i: int, sh: BitmapIndex) -> np.ndarray:
            node = Planner(sh, optimize=optimize).plan_group_count(c, e)
            cache = caches[i] if caches is not None else None
            return Executor(sh, backend=backend, cache=cache,
                            device=device).run_group_count(node)

        parts = self._fan_out(key, run_shard, ("gcount", c, e), pool,
                              backend, optimize)
        out = np.zeros(self.card(c), dtype=np.int64)
        for p in parts:
            out += p
        return out

    # -- measure aggregates (compressed-domain OLAP) ------------------------
    @property
    def measure_names(self) -> List[str]:
        return self.shards[0].measure_names

    def agg(self, measure, e=None, backend: str = "auto",
            optimize: bool = True, caches: Optional[List[Dict]] = None,
            pool=None, device: Device = "cuda"):
        """Scalar ``(sum, count, min, max)`` of ``measure`` under filter
        ``e``: each shard slices its own measure sidecar by its filter
        intervals, the coordinator merges the four-number partials —
        bitmaps and measure values never leave their shard."""
        from .executor import Executor
        from .planner import Planner
        from .measures import merge_scalar_aggs
        if e is not None and not isinstance(e, Expr):
            raise TypeError(f"agg() takes an Expr or None, got {e!r}")
        name = str(measure)
        key = ("agg", name, backend, bool(optimize),
               canonical_key(e) if e is not None else None)

        def run_shard(i: int, sh: BitmapIndex):
            node = Planner(sh, optimize=optimize).plan_agg(name, e)
            cache = caches[i] if caches is not None else None
            return Executor(sh, backend=backend, cache=cache,
                            device=device).run_agg(node)

        parts = self._fan_out(key, run_shard, ("agg", name, e), pool,
                              backend, optimize)
        return merge_scalar_aggs(parts)

    def group_agg(self, measure, cols, e=None, backend: str = "auto",
                  optimize: bool = True,
                  caches: Optional[List[Dict]] = None, pool=None,
                  device: Device = "cuda") -> Dict:
        """GROUP BY one or two columns aggregating ``measure`` (or
        counting rows when ``None``); per-shard partial dicts merge
        elementwise (sums/counts add, mins/maxs combine against their
        identities)."""
        from .executor import Executor
        from .planner import Planner
        from .measures import merge_group_aggs
        if e is not None and not isinstance(e, Expr):
            raise TypeError(f"group_agg() takes an Expr or None, got {e!r}")
        name = None if measure is None else str(measure)
        if not isinstance(cols, (list, tuple)):
            cols = [cols]
        cs = tuple(self.resolve_column(c) for c in cols)
        key = ("gagg", name, cs, backend, bool(optimize),
               canonical_key(e) if e is not None else None)

        def run_shard(i: int, sh: BitmapIndex) -> Dict:
            node = Planner(sh, optimize=optimize).plan_group_agg(
                name, list(cs), e)
            cache = caches[i] if caches is not None else None
            return Executor(sh, backend=backend, cache=cache,
                            device=device).run_group_agg(node)

        parts = self._fan_out(key, run_shard, ("gagg", name, cs, e), pool,
                              backend, optimize)
        return merge_group_aggs(parts)

    def top_k(self, col, k: int, e=None, measure=None,
              backend: str = "auto", optimize: bool = True,
              caches: Optional[List[Dict]] = None, pool=None,
              device: Device = "cuda") -> List:
        """Top-``k`` values of ``col`` by row count (or by ``sum(measure)``)
        under filter ``e``, with *shard pruning* (TPUT-style).

        Phase 1 asks every shard for its local top-``k`` (ids, partial
        values, and its threshold ``tau`` — an upper bound on anything it
        did not report).  The coordinator forms per-group lower bounds
        (reported partials summed) and upper bounds (unreported shards
        contribute ``tau``); groups whose upper bound falls below the
        k-th best lower bound are *provably* outside the top-k and are
        never touched again.  Phase 2 fetches exact partials for the
        surviving candidates only.  Sum-pruning is only sound for
        non-negative measures — any shard observing a negative partial
        flags itself unprunable and the coordinator falls back to a full
        vector merge.  Ties break by (value desc, rank asc) — identical to
        the monolithic ``top_k_from_counts`` path.
        """
        from .dataset import top_k_from_counts, top_k_from_values
        c = self.resolve_column(col)
        k = int(k)
        if k <= 0:
            return []
        name = None if measure is None else str(measure)
        card = self.card(c)

        def full_merge() -> List:
            agg = self.group_agg(name, [c], e, backend=backend,
                                 optimize=optimize, caches=caches, pool=pool,
                                 device=device)
            if name is None:
                return top_k_from_counts(agg["counts"], k)
            return top_k_from_values(agg["sums"], agg["counts"], k)

        if card <= k or self.n_shards == 1:
            return full_merge()
        key = ("gtop", c, name, k, backend, bool(optimize),
               canonical_key(e) if e is not None else None)

        def run_gtop(i: int, sh: BitmapIndex) -> Dict:
            cache = caches[i] if caches is not None else None
            return run_shard_task(sh, ("gtop", c, e, k, name),
                                  backend=backend, optimize=optimize,
                                  cache=cache, device=device)

        parts = self._fan_out(key, run_gtop, ("gtop", c, e, k, name), pool,
                              backend, optimize)
        if not all(p["prunable"] for p in parts):
            return full_merge()
        vdt = parts[0]["vals"].dtype
        tau_total = sum(p["tau"] for p in parts)
        lb = np.zeros(card, dtype=vdt)
        ub = np.full(card, tau_total, dtype=vdt)
        for p in parts:
            lb[p["ids"]] += p["vals"]
            ub[p["ids"]] += p["vals"] - p["tau"]
        kth_lb = np.partition(lb, card - k)[card - k]
        candidates = np.flatnonzero(ub >= kth_lb)
        ids = tuple(int(g) for g in candidates)

        def run_gvals(i: int, sh: BitmapIndex) -> Dict:
            cache = caches[i] if caches is not None else None
            return run_shard_task(sh, ("gvals", c, e, ids, name),
                                  backend=backend, optimize=optimize,
                                  cache=cache, device=device)

        # candidate sets are query-dependent; phase 2 skips the result LRU
        parts2 = self._fan_out(None, run_gvals, ("gvals", c, e, ids, name),
                               pool, backend, optimize)
        vals = np.zeros(card, dtype=vdt)
        counts = np.zeros(card, dtype=np.int64)
        for p in parts2:
            vals[candidates] += p["vals"]
            counts[candidates] += p["counts"]
        if name is None:
            return top_k_from_counts(counts, k)
        return top_k_from_values(vals, counts, k)


# ---------------------------------------------------------------------------
# Fork-based shard execution: CPU-bound EWAH work beyond the GIL.
# ---------------------------------------------------------------------------

class ForkSafetyError(Exception):
    """An explicit kernel-backend request reached a forked shard worker.

    Deliberately *not* a ``RuntimeError``: ``ShardProcessPool.run_shards``
    retries ``RuntimeError`` once (racing generation bumps shut executors
    down mid-map), and a fork-safety violation must fail loudly, not be
    retried into the same violation.
    """


# True only in processes forked by a ShardProcessPool (set by the pool's
# worker initializer).  Forked children inherit the parent's ``sys.modules``
# — including an already-imported torch — and its heap, including every
# index's ``dense_cache`` of CUDA tensors, so fork safety cannot be "torch is
# not imported here"; it is "this process never *calls* into CUDA": a CUDA
# context does not survive fork, and torch refuses to re-initialize CUDA in
# a child forked after the parent used it.  The guard therefore pins forked
# workers to the pure-NumPy EWAH backend on the host (``device="cpu"``),
# which never reads the inherited dense cache and never calls a CUDA API.
_IN_FORK_WORKER = False


def _fork_worker_init() -> None:
    global _IN_FORK_WORKER
    _IN_FORK_WORKER = True


def _guard_backend(backend: str) -> str:
    """Resolve ``backend`` under the fork-safety rule (worker side).

    ``auto`` quietly degrades to ``ewah`` (the executor's kernel path is
    an optimization, never a semantic change); an *explicit* ``kernel``
    request is a caller error and raises ``ForkSafetyError``.
    """
    if not _IN_FORK_WORKER:
        return backend
    if backend == "kernel":
        raise ForkSafetyError(
            "backend='kernel' inside a forked shard worker: CUDA cannot "
            "be used in a process forked after the parent initialized it; "
            "use backend='auto'/'ewah' with ShardProcessPool, or a thread "
            "pool for kernel execution")
    return "ewah" if backend == "auto" else backend


# indexes visible to forked workers, keyed per pool.  Entries are written in
# the parent *before* its pool forks, so every worker inherits its own
# pool's index by copy-on-write — or, when the pool was given an
# ``index_dir``, the entry is ``("dir", path)`` and each worker *opens the
# shard store files via mmap* on first use: the bitmap pages are then
# file-backed and shared between all workers by the page cache instead of
# depending on fork-time COW of anonymous memory (and a worker can outlive
# parent-side mutations of the in-memory index).  Keys are never reused
# across pools.
_FORK_STATE: Dict[int, object] = {}
_FORK_CACHES: Dict = {}
_FORK_LOADED: Dict[int, "ShardedIndex"] = {}  # worker-side mmap opens
_fork_keys = itertools.count()


def _fork_index(pool_key: int) -> "ShardedIndex":
    """Resolve a worker's index: inherited object, or lazy mmap open."""
    entry = _FORK_STATE[pool_key]
    if not (isinstance(entry, tuple) and entry and entry[0] == "dir"):
        return entry  # COW-inherited ShardedIndex
    idx = _FORK_LOADED.get(pool_key)
    if idx is None:
        from .store import load_sharded
        idx = load_sharded(entry[1], mmap=True)
        _FORK_LOADED[pool_key] = idx
    return idx


def run_shard_task(sh: BitmapIndex, task, backend: str = "auto",
                   optimize: bool = True, cache: Optional[Dict] = None,
                   device: Device = "cuda"):
    """Execute one shard *statement task* against one shard.

    ``task`` mirrors the coordinator's statement kinds: ``("expr", e)``
    returns the shard's EWAH result, ``("count", e)`` its partial count and
    ``("gcount", col, e)`` its partial per-value count vector — aggregates
    ship a few integers across a process or network boundary instead of a
    bitmap.  Measure statements follow the same shape: ``("agg", measure,
    e)`` returns the shard's ``(sum, count, min, max)`` partial,
    ``("gagg", measure, cols, e)`` its grouped partial dict, ``("gtop",
    col, e, m, measure)`` its pruned top-m report (ids/vals/counts plus the
    ``tau`` threshold and a ``prunable`` flag) and ``("gvals", col, e, ids,
    measure)`` exact partials at the given candidate ids.  This is the
    single shard-side execution path shared by the fork-based
    ``ShardProcessPool`` and the RPC worker tier
    (``repro_torch.serve.worker_api``), so a worker computes exactly what
    the single-process ``ShardedIndex`` fan-out would.  ``device`` is where the shard's kernel path runs.
    """
    from .executor import Executor
    from .planner import Planner, plan
    kind = task[0]
    ex = Executor(sh, backend=backend, cache=cache, device=device)
    if kind == "expr":
        e = task[1]
        node = plan(sh, e, optimize=optimize) if isinstance(e, Expr) else e
        return ex.run(node)
    if kind == "count":
        return ex.run_count(Planner(sh, optimize=optimize).plan_count(task[1]))
    if kind == "gcount":
        return ex.run_group_count(
            Planner(sh, optimize=optimize).plan_group_count(task[1], task[2]))
    if kind == "agg":
        return ex.run_agg(
            Planner(sh, optimize=optimize).plan_agg(task[1], task[2]))
    if kind == "gagg":
        return ex.run_group_agg(
            Planner(sh, optimize=optimize).plan_group_agg(
                task[1], list(task[2]), task[3]))
    if kind == "gtop":
        col, e, m, measure = task[1], task[2], int(task[3]), task[4]
        agg = ex.run_group_agg(
            Planner(sh, optimize=optimize).plan_group_agg(measure, [col], e))
        counts = agg["counts"]
        vals = counts if measure is None else agg["sums"]
        nz = np.flatnonzero(counts)
        # sum-pruning needs non-negative partials everywhere: one negative
        # value and "unreported <= tau" no longer bounds anything
        prunable = (measure is None or not len(nz)
                    or not bool(vals[nz].min() < 0))
        order = nz[np.lexsort((nz, -vals[nz]))][:m]
        if len(nz) > m:
            tau = vals[order[-1]]
            tau = float(tau) if vals.dtype.kind == "f" else int(tau)
        else:
            tau = 0.0 if vals.dtype.kind == "f" else 0
        return {"ids": order, "vals": vals[order], "counts": counts[order],
                "tau": tau, "prunable": prunable}
    if kind == "gvals":
        col, e, ids, measure = task[1], task[2], task[3], task[4]
        ids = np.asarray(ids, dtype=np.int64)
        agg = ex.run_group_agg(
            Planner(sh, optimize=optimize).plan_group_agg(measure, [col], e))
        counts = agg["counts"]
        vals = counts if measure is None else agg["sums"]
        return {"vals": vals[ids], "counts": counts[ids]}
    raise ValueError(f"unknown shard task {kind!r}")


def _forked_run(args):
    """Worker-side shard statement execution (operand caches per worker),
    always on the host: the guarded backend never reaches the kernel."""
    pool_key, shard_i, task, backend, optimize = args
    backend = _guard_backend(backend)
    if task[0] == "probe":
        return {"pid": os.getpid(), "fork_worker": _IN_FORK_WORKER,
                "backend": backend}
    sh = _fork_index(pool_key).shards[shard_i]
    cache = _FORK_CACHES.setdefault((pool_key, shard_i), {})
    return run_shard_task(sh, task, backend=backend, optimize=optimize,
                          cache=cache, device="cpu")


class ShardProcessPool:
    """Fork-based worker pool for shard-parallel query execution.

    A thread pool only overlaps shard work while NumPy holds the GIL
    released; the compressed-domain hot path interleaves many small array
    ops with Python control flow, so threads mostly serialize.  This pool
    forks processes that inherit the whole ``ShardedIndex`` by
    copy-on-write — the index is never pickled, a query ships as a tiny
    (shard, expr) tuple and only compressed EWAH results cross the process
    boundary (``EWAH.__reduce__`` keeps them words-only).  Pass an instance
    as ``ShardedIndex.execute(..., pool=...)`` wherever a thread pool is
    accepted.

    Workers fork lazily on first use and automatically re-fork when the
    index ``generation`` changes (``replace_shard``), so a worker never
    serves a stale shard.  Per-worker operand caches persist across queries.
    Fork safety is *enforced*: every worker runs ``_fork_worker_init`` and
    ``_guard_backend`` pins it to the pure-NumPy EWAH path — ``auto``
    degrades to ``ewah``, an explicit ``kernel`` raises ``ForkSafetyError``
    — and runs it on the host (``device="cpu"``), so a worker never calls
    CUDA, whose context it cannot use after the fork, nor reads the CUDA
    tensors of the dense operand caches it inherited from the parent.
    ``run_shards(("probe",), shard_ids)`` returns each worker's pid / fork
    flag / effective backend for verification.

    With ``index_dir`` (a saved ``ShardedIndex`` store directory), workers
    do not rely on fork-time copy-on-write of the parent's heap at all:
    each worker mmap-opens the shard store files on first use, so bitmap
    words are shared page-cache pages across every worker and the parent —
    one physical copy of the index regardless of pool size.
    """

    def __init__(self, index: "ShardedIndex", workers: Optional[int] = None,
                 index_dir: Optional[str] = None):
        if "fork" not in multiprocessing.get_all_start_methods():
            raise RuntimeError(
                "ShardProcessPool needs the 'fork' start method (POSIX); "
                "use a thread pool on this platform")
        self.index = index
        self.index_dir = index_dir
        self.workers = max(int(workers or (os.cpu_count() or 2)), 1)
        self._key = next(_fork_keys)
        self._executor: Optional[ProcessPoolExecutor] = None
        self._forked_generation = -1
        self._lock = threading.Lock()

    def _ensure(self) -> ProcessPoolExecutor:
        with self._lock:
            if (self._executor is None
                    or self._forked_generation != self.index.generation):
                if self._executor is not None:
                    self._executor.shutdown(wait=False)
                    self._executor = None
                _FORK_STATE[self._key] = (
                    ("dir", self.index_dir) if self.index_dir is not None
                    else self.index)
                self._executor = ProcessPoolExecutor(
                    max_workers=min(self.workers, self.index.n_shards),
                    mp_context=multiprocessing.get_context("fork"),
                    initializer=_fork_worker_init)
                self._forked_generation = self.index.generation
            return self._executor

    def run_shards(self, task, shard_ids: Sequence[int],
                   backend: str = "auto", optimize: bool = True) -> List:
        """Run one statement task over the given shards in the workers.

        ``task`` is a ``("expr", e)`` / ``("count", e)`` / ``("gcount",
        col, e)`` / ``("agg", measure, e)`` / ``("gagg", measure, cols,
        e)`` / ``("gtop", col, e, m, measure)`` / ``("gvals", col, e, ids,
        measure)`` tuple (see ``_forked_run``); a bare expression/plan is
        accepted for backward compatibility and treated as ``("expr", e)``.
        """
        if not (isinstance(task, tuple) and task
                and task[0] in ("expr", "count", "gcount", "agg", "gagg",
                                "gtop", "gvals", "probe")):
            task = ("expr", task)
        args = [(self._key, i, task, backend, optimize) for i in shard_ids]
        # a concurrent generation bump can shut this executor down between
        # _ensure() and map(); re-ensure (against the new fork) and retry
        for attempt in (0, 1):
            ex = self._ensure()
            try:
                return list(ex.map(_forked_run, args))
            except RuntimeError:
                if attempt:
                    raise
        raise AssertionError("unreachable")

    def shutdown(self, wait: bool = False) -> None:
        with self._lock:
            if self._executor is not None:
                self._executor.shutdown(wait=wait)
                self._executor = None
            _FORK_STATE.pop(self._key, None)

    def __del__(self):  # best effort; shutdown() is the real API
        try:
            self.shutdown()
        except Exception:
            pass


AnyIndex = Union[BitmapIndex, ShardedIndex]
