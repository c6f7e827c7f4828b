"""Live ingest: WAL-backed delta indexes, compressed tombstones, compaction.

The sorted, compressed base index (the paper's whole premise: sort the fact
table, then EWAH-compress the bitmaps) is immutable by construction — a
single out-of-order row would break the run structure the sort bought.  This
module adds mutability *around* it, LSM-style, without ever touching a base
bitmap:

* ``DeltaIndex`` — an in-memory bitmap index over appended rows in arrival
  order (unsorted, k=1 for cheap incremental builds).  Full word-aligned
  partitions seal incrementally through the streaming ``IndexBuilder``; only
  the ragged tail recompiles per version, memoized.
* tombstones — one compressed EWAH per base shard plus one over the delta,
  recording deleted rows.  Deletes are evaluated *in the compressed domain*
  (the predicate's result bitmap ORs into the tombstone); nothing is
  rewritten.
* ``LiveIndex`` — the read view ``(base ⊔ delta) AND NOT tombstones``.
  Every read stays compressed-domain across the merge: each base shard and
  the delta run the statement under their effective filter (the filter's
  result less the layer's tombstone, pinned into the plan) and the
  partials merge as the base's shards' do — no global result bitmap for
  an aggregate, mirroring how the base executes.  Delta rows occupy the
  global id range starting at the base's next 32-bit word boundary, so
  layer results concatenate *exactly* (the phantom gap rows are never
  set).
* write-ahead log — every mutation is durably framed (CRC-checked, see
  ``repro_torch.core.wal``) *before* it touches memory, so a crashed
  process replays to its exact pre-crash state — bit-identical bitmaps —
  on warm start.
* devices — a ``LiveIndex`` evaluates its deletes (and their replay) on
  the ``device`` it was opened with, and every read takes the ``device``
  its layers' executors run the kernel path on.  Each layer version is its
  own ``BitmapIndex`` with its own cache of dense operands, and bitmaps are
  immutable, so no cached operand is ever stale: a compaction or a new
  delta version brings new index objects, and the old ones' device
  operands are freed with them.
* ``LiveIndex.compact()`` / ``Compactor`` — drains the delta and tombstones
  through the existing external-merge sort into a freshly sorted base
  (``StoreWriter`` files under an epoch prefix), atomically cut over via
  the manifest rewrite, then truncates the WAL to the new epoch.  Mutations
  arriving *during* a WAL-backed compaction keep flowing; the compactor
  re-applies the WAL tail onto the new base at swap time.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_device

from . import measures as _ms
from . import wal as walmod
from .ewah import EWAH, _empty_ewah
from .expr import Expr, canonical_key
from .index import BitmapIndex, ColumnIndex, IndexBuilder, WORD_ROWS
from .planner import PPinned
from .shard import ShardedIndex, merge_partials, run_shard_task

DELTA_PARTITION_ROWS = 4096

Device = Union[str, torch.device]

# repeated-statement memo for the delta layer (the base shards have their
# own per-shard LRUs); entries are keyed by delta version, so a mutation
# retires the whole working set without invalidation bookkeeping
DELTA_CACHE_ENTRIES = 128


def _align32(n: int) -> int:
    return -(-int(n) // WORD_ROWS) * WORD_ROWS


class DeltaIndex:
    """In-memory bitmap index over appended rows, in arrival order.

    No sort: rows index as they arrive (compression suffers, but the delta
    is small and short-lived by design — compaction folds it into the
    sorted base).  Encoders use the *global* cardinalities of the base at
    k=1, so per-value counts and result bitmaps merge with the base's at
    the bitmap/count level; the base's own k never needs to match.

    Full ``partition_rows`` partitions seal incrementally inside a
    streaming ``IndexBuilder``; ``index()`` stitches the sealed partitions
    with a freshly compiled ragged-tail partition into a read-only
    ``BitmapIndex`` view, memoized per mutation version.
    """

    def __init__(self, cards, column_names=None, allocation: str = "alpha",
                 partition_rows: int = DELTA_PARTITION_ROWS):
        self.cards = [int(c) for c in cards]
        self.column_names = list(column_names) if column_names else None
        self._allocation = allocation
        p = max(int(partition_rows), WORD_ROWS)
        self._partition_rows = p - p % WORD_ROWS
        # container="auto": arrival-order rows are exactly the distribution
        # where word-aligned RLE degrades — sparse chunks become position
        # arrays natively instead of paying the unsorted-RLE penalty
        self._builder = IndexBuilder(self.cards, k=1, allocation=allocation,
                                     partition_rows=self._partition_rows,
                                     column_names=self.column_names,
                                     container="auto")
        self._chunks: List[np.ndarray] = []
        self._mchunks: Dict[str, List[np.ndarray]] = {}
        self.n_rows = 0
        self._version = 0
        self._compiled = None  # (version, BitmapIndex)

    def append(self, rows: np.ndarray, measures=None) -> int:
        rows = np.ascontiguousarray(np.asarray(rows), dtype=np.int64)
        if rows.ndim != 2 or rows.shape[1] != len(self.cards):
            raise ValueError(f"rows shape {rows.shape} does not match "
                             f"{len(self.cards)} columns")
        if not len(rows):
            return 0
        if measures:
            for name, arr in measures.items():
                self._mchunks.setdefault(name, []) \
                    .append(np.ascontiguousarray(arr))
        self._chunks.append(rows)
        self._builder.append(rows)  # seals any completed partitions
        self.n_rows += len(rows)
        self._version += 1
        return len(rows)

    def rows(self) -> np.ndarray:
        """All appended rows (arrival order) — the compactor's raw input."""
        if not self._chunks:
            return np.empty((0, len(self.cards)), dtype=np.int64)
        return self._chunks[0] if len(self._chunks) == 1 \
            else np.concatenate(self._chunks, axis=0)

    def measure_rows(self) -> Optional[Dict[str, np.ndarray]]:
        """Appended measure tails, concatenated in arrival order (aligned
        row-for-row with ``rows()``), or None when measure-free."""
        if not self._mchunks:
            return None
        return {name: (chunks[0] if len(chunks) == 1
                       else np.concatenate(chunks))
                for name, chunks in self._mchunks.items()}

    def index(self) -> BitmapIndex:
        """The delta as a queryable ``BitmapIndex`` (memoized per version).

        Sealed partitions are shared by reference with the builder (EWAH
        objects are immutable); only the buffered tail rows recompile.
        """
        if self._compiled is not None and self._compiled[0] == self._version:
            return self._compiled[1]
        b = self._builder
        bounds = list(b._bounds)
        tail_rows = b._buffered
        tail_idx = None
        if tail_rows:
            tb = IndexBuilder(self.cards, k=1, allocation=self._allocation,
                              column_names=self.column_names,
                              container="auto")
            for chunk in b._buf:
                tb.append(chunk)
            tail_idx = tb.finish()
            bounds.append(bounds[-1] + tail_rows)
        columns = []
        for c, col in enumerate(b.columns):
            bitmaps = list(col.bitmaps)
            if tail_idx is not None:
                bitmaps.append(tail_idx.columns[c].bitmaps[0])
            columns.append(ColumnIndex(encoder=col.encoder, bitmaps=bitmaps))
        idx = BitmapIndex(n_rows=self.n_rows, columns=columns,
                          partition_bounds=np.asarray(bounds, dtype=np.int64),
                          column_names=self.column_names,
                          measures=self.measure_rows())
        self._compiled = (self._version, idx)
        return idx

    @property
    def size_words(self) -> int:
        return self.index().size_words if self.n_rows else 0


class LiveIndex:
    """Mutable LSM-shaped view: ``(base ⊔ delta) AND NOT tombstones``.

    ``base`` is an immutable sorted ``ShardedIndex`` (possibly
    memmap-opened); appends land in a ``DeltaIndex``, deletes in per-shard
    compressed tombstones.  Every mutation is WAL-framed first (when a WAL
    is attached), so warm start replays to the exact pre-crash bitmaps.

    Reads snapshot the layer references under the mutation lock and then
    execute lock-free: EWAH bitmaps are immutable, and tombstones are
    replaced, never mutated in place.  Base-layer execution reuses the
    shards' per-expression LRU caches — tombstones apply *outside* the
    cached per-shard results, so cache entries stay valid across deletes.

    Global row ids: base rows keep their ids; delta row ``i`` is
    ``align32(base.n_rows) + i``.  The phantom gap rows are never set, so
    per-layer result bitmaps concatenate exactly and counts are unaffected.

    ``device`` is where deletes (and their WAL replay) run the kernel path;
    reads take their own ``device``, ``None`` meaning this one.
    """

    def __init__(self, base, dir_path: Optional[str] = None,
                 wal_path: Optional[str] = None, fsync: bool = False,
                 sync: Optional[bool] = None,
                 recipe: Optional[Dict] = None,
                 delta_partition_rows: int = DELTA_PARTITION_ROWS,
                 device: Device = "cuda"):
        self.device = resolve_device(device)
        if isinstance(base, BitmapIndex):
            base = ShardedIndex([base])
        self.base = base
        self.dir_path = dir_path
        # WAL durability knob (see repro_torch.core.wal.WAL): default off —
        # frames flush to the page cache per append, fsync=True gates every
        # acknowledgement on stable storage.  ``sync=`` is the legacy alias.
        self.sync = bool(fsync if sync is None else sync)
        self.cards = [base.card(c) for c in range(base.n_columns)]
        self.column_names = base.column_names
        # the measure contract appended batches must honor (all-or-nothing:
        # a live dataset either carries every declared measure on every
        # append, or none at all — a sidecar with holes cannot aggregate)
        base_measures = getattr(base.shards[0], "measures", None) \
            if base.n_shards else None
        self.measure_spec: Dict[str, str] = {
            name: _ms.measure_dtype_str(np.asarray(arr))
            for name, arr in (base_measures or {}).items()}
        meta: Dict = {}
        if dir_path is not None:
            from . import store
            meta = store.manifest_meta(dir_path)
        self.epoch = int(meta.get("epoch", 0))
        # the build recipe compaction replays: sort order + encoding of the
        # base, from the store manifest when present, overridable by the
        # Dataset façade
        self.recipe = {
            "sort_order": meta.get("sort_order"),
            "cards": self.cards,
            "k": int(meta.get("k", 1)),
            "allocation": meta.get("allocation", "alpha"),
            "partition_rows": meta.get("partition_rows"),
            # layout provenance (order, frequency remaps) rides along so a
            # compaction rebuild re-applies the same physical layout
            "layout": meta.get("layout"),
        }
        if recipe:
            self.recipe.update(recipe)
        self._delta_partition_rows = delta_partition_rows
        self.delta = self._new_delta()
        self._tombs: List[Optional[EWAH]] = [None] * base.n_shards
        self._dtomb: Optional[EWAH] = None
        self._dcache: Dict = {}
        self._lock = threading.RLock()
        self.generation = 0
        self.compactions = 0
        if wal_path is None and dir_path is not None:
            wal_path = os.path.join(
                dir_path, meta.get("wal") or f"wal-{self.epoch:05d}.log")
        self.wal: Optional[walmod.WAL] = None
        if wal_path is not None:
            self.wal = walmod.WAL(wal_path, fsync=self.sync)
            if self.wal.n_frames == 0:
                self.wal.log_epoch(self.epoch)
            else:
                self._replay(self.wal.replayed)

    def _new_delta(self) -> DeltaIndex:
        return DeltaIndex(self.cards, column_names=self.column_names,
                          allocation=self.recipe.get("allocation", "alpha"),
                          partition_rows=self._delta_partition_rows)

    def _replay(self, frames) -> None:
        """Apply already-logged WAL frames (warm start): appends refill the
        delta, deletes re-evaluate their predicates in original order —
        each sees exactly the rows that existed when it was logged, so the
        reconstructed tombstones are bit-identical to the pre-crash ones."""
        for fi, (kind, payload) in enumerate(frames):
            k, val = walmod.decode_frame(kind, payload)
            if k == "epoch":
                if fi == 0 and val != self.epoch:
                    raise walmod.WALError(
                        f"{self.wal.path}: WAL is for epoch {val}, store "
                        f"manifest says epoch {self.epoch} — stale or "
                        f"misplaced log")
            elif k == "append":
                self.delta.append(val)
            elif k == "appendm":
                self.delta.append(val[0], measures=val[1])
            else:
                self._apply_delete(val)

    # -- shape / stats -------------------------------------------------------
    @property
    def n_rows(self) -> int:
        """Live row count (base + delta, minus tombstoned rows)."""
        return self.base.n_rows + self.delta.n_rows - self.tombstone_rows

    @property
    def tombstone_rows(self) -> int:
        dead = sum(t.count() for t in self._tombs if t is not None)
        if self._dtomb is not None:
            dead += self._dtomb.count()
        return dead

    @property
    def pending_rows(self) -> int:
        """Compaction debt: rows the next compaction would fold away."""
        return self.delta.n_rows + self.tombstone_rows

    @property
    def n_columns(self) -> int:
        return self.base.n_columns

    @property
    def n_shards(self) -> int:
        return self.base.n_shards

    @property
    def n_bitmaps(self) -> int:
        return self.base.n_bitmaps

    @property
    def n_partitions(self) -> int:
        didx = self.delta
        return self.base.n_partitions + \
            (didx.index().n_partitions if didx.n_rows else 0)

    @property
    def size_words(self) -> int:
        words = self.base.size_words + self.delta.size_words
        words += sum(t.size_words for t in self._tombs if t is not None)
        if self._dtomb is not None:
            words += self._dtomb.size_words
        return words

    @property
    def measure_names(self) -> List[str]:
        return sorted(self.measure_spec)

    def card(self, col: int) -> int:
        return self.base.card(col)

    def resolve_column(self, key) -> int:
        return self.base.resolve_column(key)

    def stats(self) -> Dict:
        with self._lock:
            return {
                "epoch": self.epoch,
                "compactions": self.compactions,
                "base_rows": self.base.n_rows,
                "delta_rows": self.delta.n_rows,
                "tombstone_rows": self.tombstone_rows,
                "n_rows": self.n_rows,
                "wal_bytes": self.wal.size_bytes if self.wal else 0,
                "wal_frames": self.wal.n_frames if self.wal else 0,
                "generation": self.generation,
            }

    def close(self) -> None:
        if self.wal is not None:
            self.wal.close()

    # -- mutations -----------------------------------------------------------
    def _check_rows(self, rows) -> np.ndarray:
        """Validate *before* logging: the WAL must never record a batch its
        own replay would reject."""
        rows = np.ascontiguousarray(np.asarray(rows), dtype=np.int64)
        if rows.ndim != 2 or (len(rows) and rows.shape[1] != len(self.cards)):
            raise ValueError(f"rows shape {rows.shape} does not match "
                             f"{len(self.cards)} columns")
        for c, card in enumerate(self.cards):
            if len(rows) and (int(rows[:, c].min()) < 0
                              or int(rows[:, c].max()) >= card):
                raise ValueError(
                    f"column {c} has value rank outside [0, {card})")
        return rows

    def _check_measures(self, measures, n_rows: int):
        """Enforce the all-or-nothing measure contract *before* logging."""
        if not self.measure_spec:
            if measures:
                raise ValueError(
                    f"append() got measures {sorted(measures)} but this "
                    f"live index declares none")
            return None
        if measures is None or set(measures) != set(self.measure_spec):
            raise ValueError(
                f"this live index carries measures "
                f"{sorted(self.measure_spec)}; append() must supply exactly "
                f"those (got {sorted(measures or {})})")
        measures = _ms.normalize_measures(measures, n_rows)
        # coerce to the declared dtype: an int batch for a float measure is
        # fine, the sidecar's dtype is the contract
        return {name: np.ascontiguousarray(
                    arr, dtype=np.dtype(self.measure_spec[name]))
                for name, arr in measures.items()}

    def append(self, rows, measures=None) -> int:
        """Durably append a batch of rows (WAL frame first, then delta).

        When the base carries a measure sidecar, ``measures`` must supply a
        value for *every* declared measure (``{name: 1-D array}``, aligned
        with ``rows``); the batch is framed as a ``KIND_APPENDM`` WAL
        record so replay reconstructs the values bit-exactly."""
        rows = self._check_rows(rows)
        measures = self._check_measures(measures, len(rows))
        if not len(rows):
            return 0
        with self._lock:
            if self.wal is not None:
                self.wal.log_append(rows, measures)
            self.delta.append(rows, measures)
            self.generation += 1
        return len(rows)

    def delete(self, e: Expr) -> int:
        """Durably delete every live row matching ``e``; returns how many.

        The predicate is WAL-framed declaratively (its wire expression) and
        evaluated in the compressed domain: the result bitmap ORs into each
        layer's tombstone, nothing decompresses, nothing rewrites.
        """
        if not isinstance(e, Expr):
            raise TypeError(f"delete() takes an Expr, got {e!r}")
        with self._lock:
            if self.wal is not None:
                self.wal.log_delete(e)
            removed = self._apply_delete(e)
            self.generation += 1
        return removed

    def _apply_delete(self, e: Expr) -> int:
        removed = 0
        if self.base.n_rows:
            for i, p in enumerate(self.base.partials(
                    ("expr", e), device=self.device)):
                t = self._tombs[i]
                if t is None:
                    if p.count():
                        removed += p.count()
                        self._tombs[i] = p
                else:
                    removed += p.count() - p.and_count(t)
                    self._tombs[i] = t | p
        if self.delta.n_rows:
            dres = run_shard_task(self.delta.index(), ("expr", e),
                                  device=self.device)
            dt = self._dtomb.pad_to(self.delta.n_rows) \
                if self._dtomb is not None else None
            if dt is None:
                if dres.count():
                    removed += dres.count()
                    self._dtomb = dres
            else:
                removed += dres.count() - dres.and_count(dt)
                self._dtomb = dt | dres
        return removed

    # -- reads ---------------------------------------------------------------
    def _snapshot(self):
        """Consistent layer references for one lock-free read (bitmaps are
        immutable; tombstones are replaced, never mutated)."""
        with self._lock:
            didx = self.delta.index() if self.delta.n_rows else None
            dn = self.delta.n_rows
            dt = self._dtomb.pad_to(dn) \
                if (self._dtomb is not None and dn) else None
            # the delta memo's key: versions restart with each compaction's
            # new delta, so the compaction count keeps keys of different
            # deltas apart (a version alone would serve an older delta's
            # result to a newer delta at the same version)
            return self.base, list(self._tombs), \
                (didx, (self.compactions, self.delta._version)), dn, dt

    def _delta_result(self, dsnap, e: Expr, backend: str, optimize: bool,
                      device: torch.device) -> EWAH:
        """Delta-layer result bitmap of ``e``, memoized per delta version.

        Tombstones are applied by the caller (outside the memo), so
        deletes never invalidate entries; appends bump the version and the
        old working set simply stops being addressed.  ``dsnap`` is the
        ``(index, version)`` pair captured under the snapshot lock —
        keying by the snapshotted version keeps a read racing an append
        from filing the old index's result under the new version.
        """
        didx, dver = dsnap
        key = (dver, backend, bool(optimize), canonical_key(e))
        hit = self._dcache.get(key)
        if hit is None:
            hit = run_shard_task(didx, ("expr", e), backend=backend,
                                 optimize=optimize, device=device)
            if len(self._dcache) >= DELTA_CACHE_ENTRIES:
                self._dcache.clear()
            self._dcache[key] = hit
        return hit

    def _device(self, device: Optional[Device]) -> torch.device:
        return self.device if device is None else resolve_device(device)

    def _partials(self, task, backend: str, optimize: bool, pool,
                  device: Optional[Device]) -> List:
        """Per-layer partials of one statement task whose filter comes
        last, in row order, for ``merge_partials``.

        One snapshot serves every layer.  A base with no tombstone runs
        the task through ``ShardedIndex.partials`` (its shard LRUs).
        Otherwise each non-empty shard runs it under its effective filter
        — the filter's per-shard result (LRU-cached) less the shard's
        tombstone — pinned into its plan; the delta does the same with its
        memoized filter result (``_delta_result``) and its tombstone.  A
        result bitmap's last base part is padded to the word boundary where
        the delta's row ids start."""
        e = task[-1]
        if e is not None and not isinstance(e, Expr):
            raise TypeError(f"LiveIndex statements take an Expr filter "
                            f"(each layer plans it), got {e!r}")
        device = self._device(device)
        base, tombs, dsnap, dn, dt = self._snapshot()
        parts: List = []
        if base.n_rows:
            if all(t is None for t in tombs):
                parts = base.partials(task, backend, optimize, pool=pool,
                                      device=device)
            else:
                fparts = base.partials(
                    ("expr", e), backend, optimize, pool=pool,
                    device=device) if e is not None else [None] * len(tombs)
                parts = [run_shard_task(sh, _pinned(task, fp, t), backend,
                                        optimize, device=device)
                         for sh, t, fp in zip(base.shards, tombs, fparts)
                         if sh.n_rows]
        if dsnap[0] is not None:
            gap = _align32(base.n_rows) - base.n_rows
            if task[0] == "expr" and parts and gap:
                parts[-1] = parts[-1].pad_to(parts[-1].n_bits + gap)
            fp = self._delta_result(dsnap, e, backend, optimize, device) \
                if e is not None else None
            parts.append(run_shard_task(dsnap[0], _pinned(task, fp, dt),
                                        backend, optimize, device=device))
        return parts

    def execute(self, e, backend: str = "auto", optimize: bool = True,
                pool=None, device: Optional[Device] = None) -> EWAH:
        """The live result bitmap of ``e``: per-shard base results (cached
        in the shards' LRUs) minus their tombstones, concatenated with the
        delta result minus its tombstone across the word-aligned gap."""
        if not isinstance(e, Expr):
            raise TypeError("LiveIndex executes Expr trees (each layer "
                            "plans independently); got a plan node")
        parts = self._partials(("expr", e), backend, optimize, pool, device)
        return merge_partials("expr", parts) if parts else _empty_ewah(0)

    def count(self, e: Optional[Expr] = None, backend: str = "auto",
              optimize: bool = True, pool=None,
              device: Optional[Device] = None) -> int:
        """COUNT(*) under ``e`` — the compressed-domain popcounts of each
        layer's filter result less its tombstone (the base's results from
        the shard LRUs, as ``execute``'s); no result bitmap of the whole
        view ever exists.  ``e=None`` counts from the tombstones alone."""
        if e is None:
            base, tombs, dsnap, dn, dt = self._snapshot()
            dead = sum(t.count() for t in tombs if t is not None)
            return base.n_rows - dead + dn - (dt.count() if dt else 0)
        return merge_partials("count", [p.count() for p in self._partials(
            ("expr", e), backend, optimize, pool, device)])

    def group_count(self, col, e: Optional[Expr] = None,
                    backend: str = "auto", optimize: bool = True,
                    pool=None, device: Optional[Device] = None) -> np.ndarray:
        """GROUP BY ``col`` COUNT(*) under ``e``: per-layer partial count
        vectors (the ``counts`` of each layer's one-column group-by),
        summed."""
        c = self.resolve_column(col)
        parts = self._partials(("gcount", c, e), backend, optimize, pool,
                               device)
        if not parts:
            return np.zeros(self.card(c), dtype=np.int64)
        return merge_partials("gcount", parts)

    def agg(self, measure, e: Optional[Expr] = None, backend: str = "auto",
            optimize: bool = True, pool=None,
            device: Optional[Device] = None):
        """Scalar ``(sum, count, min, max)`` of ``measure`` under ``e``,
        compressed-domain across the base+delta merge: each layer slices
        its own measure sidecar with its effective filter and the partial
        tuples merge — no row reconstruction anywhere."""
        name = str(measure)
        if name not in self.measure_spec:
            raise KeyError(f"unknown measure {name!r}; this live index "
                           f"declares {sorted(self.measure_spec)}")
        return merge_partials("agg", self._partials(
            ("agg", name, e), backend, optimize, pool, device))

    def group_agg(self, measure, cols, e: Optional[Expr] = None,
                  backend: str = "auto", optimize: bool = True, pool=None,
                  device: Optional[Device] = None):
        """Grouped aggregates over one or two columns across the base+delta
        merge (``measure=None`` computes counts only) — same per-layer
        partial shape as ``Executor.run_group_agg``, merged elementwise."""
        name = None if measure is None else str(measure)
        if name is not None and name not in self.measure_spec:
            raise KeyError(f"unknown measure {name!r}; this live index "
                           f"declares {sorted(self.measure_spec)}")
        if isinstance(cols, (int, np.integer, str)):
            cols = [cols]
        cs = tuple(self.resolve_column(c) for c in cols)
        parts = self._partials(("gagg", name, cs, e), backend, optimize,
                               pool, device)
        if not parts:
            shape = tuple(self.card(c) for c in cs)
            return _ms.empty_group_agg(cs, shape, name,
                                       self.measure_spec.get(name)
                                       if name else None)
        return merge_partials("gagg", parts)

    # -- compaction ----------------------------------------------------------
    def compact(self, relayout: bool = False) -> Dict:
        """Fold delta + tombstones into a freshly sorted, compacted base.

        ``relayout=True`` re-runs the layout advisor (column order +
        frequency remaps) over the merged rows before the rebuild, so the
        new epoch's physical layout reflects the data as it is *now*, not
        as it was at the original build.

        Reconstructs the live rows (base rows through interval scatter with
        tombstones masked out, plus undeleted delta rows), re-sorts them by
        the build recipe through the external-merge path, rebuilds the
        shards, and — when store-backed — persists the new epoch's shard
        files under an ``eNNNNN-`` prefix with the manifest rewrite as the
        atomic cutover, then starts a fresh WAL for the new epoch.

        With a WAL attached the expensive rebuild runs *outside* the
        mutation lock: appends/deletes keep landing (and keep being
        logged), and at swap time the WAL tail since the snapshot is
        copied into the new epoch's log and re-applied onto the new base.
        A crash anywhere leaves a consistent store: before the manifest
        rewrite the old manifest + old WAL still describe the exact live
        state; after it, the new manifest + new WAL do.
        """
        from . import store
        lock_held = True
        old_wal = None
        old_names: List[str] = []
        self._lock.acquire()
        try:
            base, tombs = self.base, list(self._tombs)
            drows = self.delta.rows()
            dmeas = self.delta.measure_rows()
            dn = self.delta.n_rows
            dt = self._dtomb.pad_to(dn) \
                if (self._dtomb is not None and dn) else None
            snap_frames = self.wal.n_frames if self.wal is not None else 0
            if self.wal is not None:
                # mutations may continue: the WAL records them, the tail
                # replays onto the new base at swap time
                self._lock.release()
                lock_held = False
            table, msr = self._reconstruct(base, tombs, drows, dt, dmeas)
            new_base = self._rebuild(table, measures=msr, relayout=relayout)
            if not lock_held:
                self._lock.acquire()
                lock_held = True
            tail = []
            if self.wal is not None:
                frames, _ = walmod.replay(self.wal.path)
                tail = frames[snap_frames:]
            new_epoch = self.epoch + 1
            old_wal = self.wal
            new_wal = None
            wal_name = None
            try:
                if self.wal is not None:
                    if self.dir_path is not None:
                        wal_name = f"wal-{new_epoch:05d}.log"
                        new_wal_path = os.path.join(self.dir_path, wal_name)
                    else:
                        new_wal_path = self.wal.path + ".next"
                    new_wal = walmod.WAL(new_wal_path, fsync=self.sync)
                    new_wal.log_epoch(new_epoch)
                    for kind, payload in tail:
                        new_wal.log(kind, payload)
                if self.dir_path is not None:
                    old_names = [f[0] for f in
                                 store.shard_fingerprints(self.dir_path)]
                    meta = {
                        "sort_order": self.recipe.get("sort_order"),
                        "cards": self.recipe.get("cards") or self.cards,
                        "k": self.recipe.get("k", 1),
                        "allocation": self.recipe.get("allocation", "alpha"),
                        "partition_rows": self.recipe.get("partition_rows"),
                        "layout": self.recipe.get("layout"),
                        "epoch": new_epoch,
                        "wal": wal_name,
                    }
                    # shard files first, manifest last: the rename IS the
                    # cutover
                    store.save_sharded(new_base, self.dir_path, meta=meta,
                                       prefix=f"e{new_epoch:05d}-")
            except BaseException:
                # a failed compaction leaves the old manifest + old WAL as
                # the live truth; the half-built next-epoch log must be
                # retired too, or a retry would append its epoch frame and
                # tail AFTER this attempt's stale copies — replay after the
                # retry's cutover would then double-apply the tail
                if new_wal is not None:
                    new_wal.close()
                    try:
                        os.unlink(new_wal.path)
                    except OSError:
                        pass
                raise
            # swap under the lock: concurrent readers snapshot either the
            # whole old stack or the whole new one
            self.base = new_base
            self._tombs = [None] * new_base.n_shards
            self.delta = self._new_delta()
            self._dtomb = None
            self._dcache = {}
            self.epoch = new_epoch
            self.wal = new_wal
            for kind, payload in tail:
                k, val = walmod.decode_frame(kind, payload)
                if k == "append":
                    self.delta.append(val)
                elif k == "appendm":
                    self.delta.append(val[0], measures=val[1])
                elif k == "delete":
                    self._apply_delete(val)
            self.compactions += 1
            self.generation += 1
        finally:
            if lock_held:
                self._lock.release()
        # retired files: open mmaps keep the old inodes alive, so this is
        # safe under concurrent readers; a crash before this point merely
        # leaves orphans the next compaction's sweep also ignores
        if old_wal is not None:
            old_path = old_wal.path
            old_wal.close()
            if self.dir_path is None and self.wal is not None:
                # no manifest to cut over: promote the new log in place
                os.replace(self.wal.path, old_path)
                self.wal.path = old_path
            else:
                try:
                    os.unlink(old_path)
                except OSError:
                    pass
        if self.dir_path is not None:
            from . import store
            keep = {f[0] for f in store.shard_fingerprints(self.dir_path)}
            for name in old_names:
                if name not in keep:
                    try:
                        os.unlink(os.path.join(self.dir_path, name))
                    except OSError:
                        pass
        return {"epoch": self.epoch, "n_rows": self.n_rows,
                "base_rows": self.base.n_rows,
                "size_words": self.base.size_words,
                "reapplied_frames": len(tail)}

    def _reconstruct(self, base: ShardedIndex, tombs, drows: np.ndarray,
                     dt: Optional[EWAH], dmeas=None):
        """-> ``(table, measures|None)``: the live rows, plus the aligned
        measure sidecar values of exactly those rows (base values masked by
        tombstones, delta tails masked by the delta tombstone)."""
        parts: List[np.ndarray] = []
        mparts: Dict[str, List[np.ndarray]] = \
            {name: [] for name in self.measure_spec}
        for sh, t in zip(base.shards, tombs):
            if not sh.n_rows:
                continue
            keep = ~t if t is not None else None
            parts.append(sh.reconstruct_rows(keep))
            for name in mparts:
                vals = np.asarray(sh.measures[name])
                if t is not None:
                    mask = np.ones(sh.n_rows, dtype=bool)
                    mask[t.set_bits()] = False
                    vals = vals[mask]
                mparts[name].append(vals)
        if len(drows):
            alive = None
            if dt is not None:
                alive = np.ones(len(drows), dtype=bool)
                alive[dt.set_bits()] = False
                drows = drows[alive]
            if len(drows):
                parts.append(drows)
                for name in mparts:
                    vals = np.asarray((dmeas or {})[name])
                    mparts[name].append(vals[alive] if alive is not None
                                        else vals)
        measures = None
        if mparts:
            measures = {
                name: (np.concatenate(chunks) if chunks else
                       np.empty(0, dtype=np.dtype(self.measure_spec[name])))
                for name, chunks in mparts.items()}
        if not parts:
            return np.empty((0, len(self.cards)), dtype=np.int64), measures
        table = parts[0] if len(parts) == 1 \
            else np.concatenate(parts, axis=0)
        return table, measures

    def _rebuild(self, table: np.ndarray, measures=None,
                 relayout: bool = False) -> ShardedIndex:
        from .dataset import DEFAULT_CHUNK_ROWS, _build_from_chunks
        from .layout import LayoutDecision, LayoutStats
        n = len(table)
        chunk = DEFAULT_CHUNK_ROWS
        if relayout and n:
            # re-run the layout advisor on the merged rows: as deltas
            # accumulate across epochs the original order/remaps drift from
            # optimal; this is how a live dataset converges back
            stats = LayoutStats()
            for s in range(0, n, chunk):
                stats.observe(table[s:s + chunk])
            decision = stats.decision(sort="lex", remap=True,
                                      cards=self.cards)
            self.recipe["sort_order"] = decision.order
            self.recipe["layout"] = decision.to_meta()
        order = self.recipe.get("sort_order")
        layout = LayoutDecision.from_meta(self.recipe.get("layout"))
        remaps = layout.remaps if layout is not None else None
        if order is not None and n > 1:
            from .sorting import external_merge_sort_perm
            perm = external_merge_sort_perm(table, chunk, order,
                                            remaps=remaps)
            table = table[perm]
            if measures:
                measures = {name: np.asarray(vals)[perm]
                            for name, vals in measures.items()}
        idx = _build_from_chunks(
            (table[s:s + chunk] for s in range(0, max(n, 1), chunk)),
            n, self.cards, self.recipe.get("k", 1),
            self.recipe.get("allocation", "alpha"), self.base.n_shards,
            self.recipe.get("partition_rows"), self.column_names,
            remaps=remaps, measures=measures)
        if not isinstance(idx, ShardedIndex):
            idx = ShardedIndex([idx], column_names=self.column_names)
        return idx


def _pinned(task, fp: Optional[EWAH], t: Optional[EWAH]):
    """``task`` under one layer's effective filter: the filter's result
    ``fp`` (``None``: every row) less the tombstone ``t``, pinned into the
    plan as an already-evaluated bitmap; the task as it is when neither
    is there."""
    if fp is None and t is None:
        return task
    eff = ~t if fp is None else (fp if t is None else fp.andnot(t))
    return task[:-1] + (PPinned(eff),)


class Compactor:
    """Background compaction driver: a daemon thread that compacts the
    ``LiveIndex`` whenever enough mutation debt (delta rows + tombstoned
    rows) has accumulated, checked every ``interval`` seconds.

    ``on_compact(info)`` fires after each successful compaction — the
    serving layer hooks its cache/fingerprint invalidation there.  Errors
    never kill the thread; the latest one is exposed via ``stats()``.
    """

    def __init__(self, live: LiveIndex, interval: float = 30.0,
                 min_pending_rows: int = 1, on_compact=None,
                 relayout: bool = False):
        self.live = live
        self.interval = float(interval)
        self.min_pending_rows = max(int(min_pending_rows), 1)
        self.on_compact = on_compact
        # relayout=True: every epoch re-runs the layout advisor, so the
        # physical layout tracks the (drifting) live data distribution
        self.relayout = bool(relayout)
        self.n_runs = 0
        self.last_error: Optional[str] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="compactor",
                                        daemon=True)

    def start(self) -> "Compactor":
        self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = 10.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout)

    def maybe_compact(self) -> Optional[Dict]:
        """Compact now if the debt threshold is met; returns the compaction
        info dict, or None if there was nothing to do."""
        if self.live.pending_rows < self.min_pending_rows:
            return None
        info = self.live.compact(relayout=self.relayout)
        self.n_runs += 1
        if self.on_compact is not None:
            self.on_compact(info)
        return info

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.maybe_compact()
            except Exception as exc:  # noqa: BLE001 - surfaced via stats()
                self.last_error = f"{type(exc).__name__}: {exc}"

    def stats(self) -> Dict:
        return {"interval": self.interval,
                "min_pending_rows": self.min_pending_rows,
                "runs": self.n_runs,
                "relayout": self.relayout,
                "alive": self._thread.is_alive(),
                "last_error": self.last_error}
