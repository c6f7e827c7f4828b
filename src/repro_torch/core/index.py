"""Bitmap index over a fact table (paper §2, §4 — Algorithm 3 semantics).

Construction cost matches Algorithm 3's O(n·k·d + L): per column we scatter
(row, bitmap) pairs, group by bitmap, and build each EWAH bitmap straight from
its set-bit positions (clean 0x00 runs between touched words are emitted in
constant time per run, as in the word-aligned appender of Algorithm 3).

The index is horizontally partitioned (the paper writes 256 MB blocks); each
partition holds its own compressed bitmaps and queries concatenate results.

Construction is *streaming*: ``IndexBuilder`` accepts arbitrary row chunks via
``append`` (e.g. straight from ``sorting.external_sorted_chunks``), buffers at
most one partition of rows, and compiles each completed partition into its
EWAH bitmaps.  ``BitmapIndex.build`` is a thin single-shot wrapper over it.
Partition bounds are validated to be 32-bit-word multiples at build time, so
``concat_bitmaps`` can always stitch per-partition results exactly.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.kernels import _trace
from .encoding import ColumnEncoder, choose_k
from .ewah import EWAH, and_many


@dataclass
class ColumnIndex:
    encoder: ColumnEncoder
    # bitmaps[partition][bitmap_id] -> EWAH
    bitmaps: List[List[EWAH]] = field(default_factory=list)
    # memoized bitmap_sizes(); planning reads sizes on every query, and
    # walking L EWAH objects per plan dominated sharded execution
    _sizes_cache: Optional[np.ndarray] = field(
        default=None, repr=False, compare=False)
    # lazily-memoized true cardinalities (set-bit counts) per bitmap id;
    # only the bitmaps a plan actually references pay the decode
    _counts_cache: Dict[int, int] = field(
        default_factory=dict, repr=False, compare=False)
    # lazily-memoized run catalog of the value-rank partition (see
    # ``run_catalog``); never built at open
    _catalog_cache: Optional[Tuple[np.ndarray, np.ndarray]] = field(
        default=None, repr=False, compare=False)

    @property
    def size_words(self) -> int:
        return int(self.bitmap_sizes().sum())

    def bitmap_sizes(self) -> np.ndarray:
        """Per-bitmap compressed words, summed over partitions (Fig. 4).

        Cached after the first call (the builder invalidates on append);
        treat the returned array as read-only."""
        if self._sizes_cache is None:
            out = np.zeros(self.encoder.L, dtype=np.int64)
            for part in self.bitmaps:
                for b, bm in enumerate(part):
                    out[b] += bm.size_words
            self._sizes_cache = out
        return self._sizes_cache

    def bitmap_count(self, bitmap_id: int) -> int:
        """True cardinality (set-bit count) of one bitmap, summed over
        partitions — the planner's selectivity signal beyond compressed
        size.  Each partition's ``EWAH.count()`` is itself memoized, so the
        first call pays one compressed-domain popcount per partition and
        repeats are dictionary lookups."""
        cnt = self._counts_cache.get(bitmap_id)
        if cnt is None:
            cnt = sum(part[bitmap_id].count() for part in self.bitmaps)
            self._counts_cache[bitmap_id] = cnt
        return cnt

    def run_catalog(self,
                    build: Callable[[], Tuple[np.ndarray, np.ndarray]]):
        """The column's run catalog over its index's rows — sorted run
        starts and each run's rank (``measures.run_catalog``) — and whether
        this call built it.

        ``build()`` makes it on the first call; later calls, whatever
        their filter, return the same arrays for the index's lifetime.
        Concurrent first calls may each build: the last one stored wins,
        as every build gives the same arrays.  Treat them as read-only."""
        cat = self._catalog_cache
        if cat is not None:
            return cat, False
        cat = build()
        self._catalog_cache = cat
        return cat, True

    def invalidate_sizes(self) -> None:
        self._sizes_cache = None
        self._counts_cache.clear()
        self._catalog_cache = None

    def bitmap_uncompressed_words(self, n_rows_per_part: Sequence[int]) -> np.ndarray:
        total = sum(-(-r // 32) for r in n_rows_per_part)
        return np.full(self.encoder.L, total, dtype=np.int64)


WORD_ROWS = 32  # rows per 32-bit word: the partition-alignment quantum


def validate_partition_rows(partition_rows: Optional[int]) -> Optional[int]:
    """Partition sizes must be 32-bit-word multiples (or None = one partition).

    ``concat_bitmaps`` can only stitch word-aligned interior partitions; a
    misaligned size used to slip through the builder and fail only at query
    time, deep inside the concatenation.  Fail at build time instead.
    """
    if partition_rows is None:
        return None
    p = int(partition_rows)
    if p <= 0:
        raise ValueError(f"partition_rows must be positive, got {partition_rows}")
    if p % WORD_ROWS:
        lo, hi = p - p % WORD_ROWS, p + WORD_ROWS - p % WORD_ROWS
        raise ValueError(
            f"partition_rows={p} is not a multiple of the {WORD_ROWS}-bit "
            f"word size; interior partitions must be word-aligned for exact "
            f"EWAH concatenation (use e.g. {lo or hi} or {hi})")
    return p


class IndexBuilder:
    """Incremental, chunk-at-a-time index construction.

    ``append(chunk)`` buffers rows and compiles every completed partition
    (``partition_rows`` rows, word-aligned) into its EWAH bitmaps — with
    ``partition_rows`` set, memory stays O(partition_rows + compressed
    index) regardless of table size.  With ``partition_rows=None`` the
    whole table is one partition, so the builder must buffer every row
    until ``finish()``; pass ``partition_rows`` (the paper's 256 MB blocks)
    whenever the table may not fit in memory.  ``finish()`` flushes the
    ragged tail partition and returns the ``BitmapIndex``.  Feeding
    globally sorted chunks (see ``sorting.external_sorted_chunks``)
    therefore yields *full-sort* compression for tables that never fit in
    memory at once.

    With ``store_path`` set, every completed partition is emitted straight
    into a durable ``repro_torch.core.store`` writer instead of being
    retained in memory — the streaming build becomes a streaming *persist*,
    peak memory stays O(partition) end to end, and ``finish()`` returns the
    index reopened from the store as read-only memmap views (zero-copy warm
    start over the file just written).

    Cardinalities must be known up front (they size the k-of-N encoders);
    chunk values are validated against them as they arrive.
    """

    def __init__(self, cards: Sequence[int], k: int = 1,
                 allocation: str = "alpha",
                 partition_rows: Optional[int] = None,
                 apply_heuristic: bool = True,
                 column_names: Optional[Sequence[str]] = None,
                 store_path: Optional[str] = None,
                 container: str = "run",
                 remaps: Optional[Sequence] = None):
        if container not in ("run", "auto"):
            raise ValueError(f"container must be 'run' or 'auto', "
                             f"got {container!r}")
        # "auto": each bitmap picks hybrid containers per 2^16-bit chunk
        # when the cost model says they beat word-aligned RLE — the
        # unsorted/delta-append path.  "run" (default) forces today's
        # run-list encoding, the right call for fully sorted batch builds.
        self.container = container
        self.cards = [int(c) for c in cards]
        d = len(self.cards)
        names = list(column_names) if column_names is not None else None
        if names is not None and len(names) != d:
            raise ValueError(
                f"column_names has {len(names)} entries for {d} columns")
        if remaps is not None and len(remaps) != d:
            raise ValueError(
                f"remaps has {len(remaps)} entries for {d} columns")
        self.column_names = names
        self.partition_rows = validate_partition_rows(partition_rows)
        self.columns: List[ColumnIndex] = []
        for c, card in enumerate(self.cards):
            kc = choose_k(card, k) if apply_heuristic else k
            # the frequency remap lives inside the encoder: the scatter in
            # _close_partition and every query lowering go through
            # encoder.codes, so original ranks stay the API everywhere
            self.columns.append(ColumnIndex(encoder=ColumnEncoder(
                card, kc, allocation,
                remap=remaps[c] if remaps is not None else None)))
        self._buf: List[np.ndarray] = []
        self._buffered = 0
        self._bounds: List[int] = [0]
        self._n_rows = 0
        self._finished = False
        self.store_path = store_path
        self._writer = None
        if store_path is not None:
            from .store import StoreWriter  # local: store imports this module
            self._writer = StoreWriter(
                store_path, [c.encoder for c in self.columns],
                self.column_names)

    def append(self, chunk: np.ndarray) -> "IndexBuilder":
        """Add a chunk of rows (any length, including ragged); returns self."""
        if self._finished:
            raise RuntimeError("IndexBuilder.finish() was already called")
        chunk = np.asarray(chunk)
        if chunk.ndim != 2 or chunk.shape[1] != len(self.cards):
            raise ValueError(
                f"chunk shape {chunk.shape} does not match {len(self.cards)} "
                f"columns")
        if len(chunk) == 0:
            return self
        for c, card in enumerate(self.cards):
            hi = int(chunk[:, c].max())
            lo = int(chunk[:, c].min())
            if lo < 0 or hi >= card:
                raise ValueError(
                    f"column {c} has value rank outside [0, {card}): "
                    f"min={lo}, max={hi}")
        self._buf.append(chunk)
        self._buffered += len(chunk)
        self._n_rows += len(chunk)
        if self.partition_rows is not None:
            while self._buffered >= self.partition_rows:
                self._close_partition(self._take(self.partition_rows))
        return self

    def finish(self, mmap: bool = True) -> BitmapIndex:
        """Flush the tail partition and return the finished index.

        In store mode the writer is finalized (header + atomic rename) and
        the index returned is the store *reopened* — memmap-backed when
        ``mmap`` (the default), so the build's partitions are already gone
        from memory by the time the caller sees the result."""
        if self._finished:
            raise RuntimeError("IndexBuilder.finish() was already called")
        if self._buffered:
            self._close_partition(self._take(self._buffered))
        self._finished = True
        if self._writer is not None:
            from .store import load
            self._writer.close()
            return load(self.store_path, mmap=mmap)
        return BitmapIndex(
            n_rows=self._n_rows, columns=self.columns,
            partition_bounds=np.asarray(self._bounds, dtype=np.int64),
            column_names=self.column_names)

    def abort(self) -> None:
        """Discard the build (removes a store writer's temp file)."""
        self._finished = True
        if self._writer is not None:
            self._writer.abort()

    # -- internals ---------------------------------------------------------
    def _take(self, n: int) -> np.ndarray:
        """Pop exactly n buffered rows (concatenating across append chunks)."""
        out, got = [], 0
        while got < n:
            head = self._buf[0]
            need = n - got
            if len(head) <= need:
                out.append(head)
                got += len(head)
                self._buf.pop(0)
            else:
                out.append(head[:need])
                self._buf[0] = head[need:]
                got += need
        self._buffered -= n
        return out[0] if len(out) == 1 else np.concatenate(out)

    def _close_partition(self, part: np.ndarray) -> None:
        """Compile one partition of rows into per-column EWAH bitmaps
        (Algorithm 3: scatter (row, bitmap) pairs, group, append runs).

        In store mode the partition's bitmaps go straight to the writer and
        are dropped — the builder never holds more than this one partition.

        Each column is the span ``build.encode`` (its k-of-N codes) and then
        ``build.index`` (its bitmaps); the counters ``index.words.literal``
        and ``index.words.fill`` add up the literal and marker words of its
        run-list bitmaps."""
        rows_part = len(part)
        part_sink: List[List[EWAH]] = []
        for c, col in enumerate(self.columns):
            enc = col.encoder
            with _trace.span("build.encode", rows=rows_part, col=c):
                codes = enc.codes(part[:, c])  # (rows_part, k)
            with _trace.span("build.index", rows=rows_part, col=c):
                rows = np.repeat(np.arange(rows_part, dtype=np.int64), enc.k)
                flat = codes.reshape(-1).astype(np.int64)
                order = np.lexsort((rows, flat))
                flat_s, rows_s = flat[order], rows[order]
                # group boundaries per bitmap id
                bms: List[EWAH] = []
                idx = np.searchsorted(flat_s, np.arange(enc.L + 1))
                for b in range(enc.L):
                    pos = rows_s[idx[b]: idx[b + 1]]
                    bms.append(EWAH.from_positions(pos, rows_part,
                                                   container=self.container))
                _count_words(bms)
            if self._writer is None:
                col.bitmaps.append(bms)
                col.invalidate_sizes()
            else:
                part_sink.append(bms)
        if self._writer is not None:
            self._writer.add_partition(part_sink, rows_part)
        self._bounds.append(self._bounds[-1] + rows_part)


def _count_words(bms: Sequence[EWAH]) -> None:
    """Bump the build's word counters by the literal and the marker words
    of the run-list bitmaps of ``bms``; container-backed ones are left
    out."""
    literal = fill = 0
    for bm in bms:
        if bm._cont is None:
            lits = len(bm.runlist().lits)
            literal += lits
            fill += bm.size_words - lits
    _trace.count("index.words.literal", literal)
    _trace.count("index.words.fill", fill)


@dataclass
class BitmapIndex:
    n_rows: int
    columns: List[ColumnIndex]
    partition_bounds: np.ndarray  # (n_parts + 1,)
    column_names: Optional[List[str]] = None
    # numeric measure sidecar: {name: 1-D int64/float64 array of n_rows
    # values, aligned with the indexed row order} — possibly zero-copy
    # memmap views when the index was opened from a store file
    measures: Optional[Dict[str, np.ndarray]] = None
    # the executor's kernel-path operands, kept on their device for the
    # index's lifetime: {("dense", device, col, bitmap_id, bucket):
    # (int32 words, int32 row flags)} — one upload per bitmap and device
    dense_cache: Dict = field(default_factory=dict, repr=False,
                              compare=False)

    @classmethod
    def build(
        cls,
        table: np.ndarray,
        k: int = 1,
        allocation: str = "alpha",
        cards: Optional[Sequence[int]] = None,
        partition_rows: Optional[int] = None,
        apply_heuristic: bool = True,
        column_names: Optional[Sequence[str]] = None,
        container: str = "run",
        remaps: Optional[Sequence] = None,
    ) -> "BitmapIndex":
        """Build the index in one shot (thin wrapper over ``IndexBuilder``).

        ``k`` is the requested encoding (paper's k-of-N); the per-column
        heuristic of §2.2 caps it by cardinality."""
        table = np.asarray(table)
        n, d = table.shape
        if cards is None:
            cards = [int(table[:, c].max()) + 1 if n else 1 for c in range(d)]
        builder = IndexBuilder(cards, k=k, allocation=allocation,
                               partition_rows=partition_rows,
                               apply_heuristic=apply_heuristic,
                               column_names=column_names,
                               container=container,
                               remaps=remaps)
        return builder.append(table).finish()

    # -- stats -------------------------------------------------------------
    @property
    def size_words(self) -> int:
        """Total compressed 32-bit words (the unit of Tables 6/7)."""
        return sum(col.size_words for col in self.columns)

    def words_per_column(self) -> List[int]:
        return [col.size_words for col in self.columns]

    @property
    def n_bitmaps(self) -> int:
        return sum(col.encoder.L for col in self.columns)

    @property
    def n_partitions(self) -> int:
        return len(self.partition_bounds) - 1

    def card(self, col: int) -> int:
        return self.columns[col].encoder.card

    @property
    def measure_names(self) -> List[str]:
        return list(self.measures) if self.measures else []

    def measure(self, name: str) -> np.ndarray:
        """The flat measure array for ``name`` (raises ``KeyError`` for an
        undeclared measure — measures are declared at build time)."""
        if not self.measures or name not in self.measures:
            raise KeyError(
                f"unknown measure {name!r}; this index declares "
                f"{self.measure_names}")
        return self.measures[name]

    def resolve_column(self, key) -> int:
        """Map a column name (if the index carries names) or position to an
        integer column position."""
        if isinstance(key, (int, np.integer)):
            c = int(key)
            if not (0 <= c < len(self.columns)):
                raise KeyError(f"column position {c} out of range")
            return c
        if self.column_names is None:
            raise KeyError(f"index has no column names; got {key!r}")
        try:
            return self.column_names.index(key)
        except ValueError:
            raise KeyError(f"unknown column {key!r}") from None

    # -- queries -----------------------------------------------------------
    def bitmap(self, col: int, bitmap_id: int) -> EWAH:
        """One physical bitmap of a column, concatenated over all partitions."""
        ci = self.columns[col]
        return concat_bitmaps([ci.bitmaps[p][bitmap_id]
                               for p in range(self.n_partitions)])

    def equality_bitmap(self, col: int, value_rank: int) -> EWAH:
        """Predicate column == value as one EWAH bitmap over all rows.

        Ranks beyond the column's cardinality match no rows (DB semantics
        for unseen values)."""
        ci = self.columns[col]
        if not (0 <= value_rank < ci.encoder.card):
            return EWAH.from_positions(np.empty(0, np.int64), self.n_rows)
        code = ci.encoder.codes(np.array([value_rank]))[0]  # (k,)
        parts = []
        for p, (s, e) in enumerate(zip(self.partition_bounds[:-1],
                                       self.partition_bounds[1:])):
            bms = [ci.bitmaps[p][b] for b in code]
            parts.append(and_many(bms))
        return concat_bitmaps(parts)

    def equality_rows(self, col: int, value_rank: int) -> np.ndarray:
        return self.equality_bitmap(col, value_rank).set_bits()

    def reconstruct_rows(self, keep: Optional[EWAH] = None) -> np.ndarray:
        """Materialize the indexed fact rows back from the bitmaps.

        Returns an ``(n_kept, n_columns)`` int64 array of value ranks, in
        row order.  ``keep`` (an EWAH over ``n_rows`` bits) restricts the
        output to its set rows — the live-ingest compactor passes the
        complement of a shard's tombstones, so deleted rows never survive
        into the rebuilt base.

        The scatter stays interval-shaped: for each value its equality
        bitmap's set intervals land in the output by two ``searchsorted``
        probes against the kept row ids, never a per-row loop.
        """
        if keep is not None and keep.n_bits != self.n_rows:
            raise ValueError(
                f"keep bitmap spans {keep.n_bits} bits, index has "
                f"{self.n_rows} rows")
        kept = keep.set_bits() if keep is not None else None
        n_out = len(kept) if kept is not None else self.n_rows
        out = np.empty((n_out, len(self.columns)), dtype=np.int64)
        for c, ci in enumerate(self.columns):
            for v in range(ci.encoder.card):
                starts, ends = self.equality_bitmap(c, v).set_intervals()
                if kept is None:
                    for s, e in zip(starts, ends):
                        out[s:e, c] = v
                else:
                    los = np.searchsorted(kept, starts)
                    his = np.searchsorted(kept, ends)
                    for lo, hi in zip(los, his):
                        out[lo:hi, c] = v
        return out


def concat_bitmaps(parts: Sequence[EWAH]) -> EWAH:
    """Concatenate per-partition bitmaps into one bitmap over all rows.

    Exact only when partition sizes are multiples of 32 bits or for the last
    partition; the builder keeps partitions word-aligned for this reason.
    """
    if len(parts) == 1:
        return parts[0]
    from .ewah import _emit

    def segs():
        for p in parts:
            if p.n_bits % 32 and p is not parts[-1]:
                raise ValueError("non-word-aligned interior partition")
            yield from p.segments()

    n_bits = sum(p.n_bits for p in parts)
    return EWAH(_emit(segs()), n_bits)


def index_from_numpy(state: Dict) -> BitmapIndex:
    """Build a ``BitmapIndex`` from plain NumPy arrays and Python scalars.

    The carry-over format between the reference package and this one (and
    any other producer): nothing in ``state`` is an object of either
    package, so an index built elsewhere answers the same queries here.

    ``state`` keys:

    - ``n_rows``: int; ``partition_bounds``: int array ``(n_parts + 1,)``;
    - ``column_names``: list of str or ``None``;
    - ``columns``: one dict per column with the encoder parameters
      ``card``, ``k``, ``allocation`` and ``remap`` (int array or
      ``None``), and ``bitmaps``: per partition, a list over bitmap ids of
      ``(ewah_words uint32 array, n_bits)`` pairs;
    - ``measures``: ``{name: 1-D array}`` or ``None``.
    """
    bounds = np.asarray(state["partition_bounds"], dtype=np.int64)
    n_parts = len(bounds) - 1
    columns: List[ColumnIndex] = []
    for c, cs in enumerate(state["columns"]):
        enc = ColumnEncoder(int(cs["card"]), int(cs["k"]), cs["allocation"],
                            remap=cs.get("remap"))
        parts = cs["bitmaps"]
        if len(parts) != n_parts:
            raise ValueError(f"column {c} has bitmaps for {len(parts)} "
                             f"partitions, bounds give {n_parts}")
        bitmaps: List[List[EWAH]] = []
        for p, part in enumerate(parts):
            if len(part) != enc.L:
                raise ValueError(f"column {c} partition {p} has {len(part)} "
                                 f"bitmaps, its encoder needs {enc.L}")
            rows_part = int(bounds[p + 1] - bounds[p])
            bms = []
            for words, n_bits in part:
                if int(n_bits) != rows_part:
                    raise ValueError(
                        f"column {c} partition {p}: bitmap of {n_bits} bits "
                        f"in a partition of {rows_part} rows")
                bms.append(EWAH(np.asarray(words, dtype=np.uint32),
                                int(n_bits)))
            bitmaps.append(bms)
        columns.append(ColumnIndex(encoder=enc, bitmaps=bitmaps))
    measures = state.get("measures")
    n_rows = int(state["n_rows"])
    if measures is not None:
        from .measures import normalize_measures
        measures = normalize_measures(measures, n_rows)
    names = state.get("column_names")
    return BitmapIndex(n_rows=n_rows, columns=columns,
                       partition_bounds=bounds,
                       column_names=list(names) if names is not None else None,
                       measures=measures)
