"""Fact-table sorting methods (paper §3.2, §4.3, §4.4).

A fact table here is an (n_rows, n_cols) integer array of *value ranks*
(column values factorized in alphabetical order), so sorting by rank is
sorting alphabetically, and — with Algorithm 2's alphabetic bitmap
allocation — lexicographic table sort == lexicographic sort of index rows.
"""
from __future__ import annotations

import heapq
import os
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence

import numpy as np

from .encoding import ColumnEncoder

MAX_GRAY_BITS = 8192  # guard: Gray sort materializes the row-bit matrix


def _key_cols(rows: np.ndarray, order: Sequence[int],
              remaps=None) -> List[np.ndarray]:
    """Sort-key columns of ``rows`` in ``order``, with the per-column
    frequency remaps (``repro_torch.core.layout``) applied where present.

    The physical sort must order rows by *encoded* rank — remapped values
    are what the alphabetic allocation lays out adjacently — so every key
    construction site (in-memory lexsort, packed spill keys, tuple spill
    keys) funnels through here.
    """
    cols = []
    for c in order:
        col = np.asarray(rows[:, c])
        r = remaps[c] if remaps is not None else None
        if r is not None:
            col = np.asarray(r, dtype=np.int64)[col]
        cols.append(col)
    return cols


def lex_sort(table: np.ndarray, col_order: Optional[Sequence[int]] = None,
             remaps=None) -> np.ndarray:
    """Return the row permutation of a lexicographic sort.

    ``col_order[0]`` is the *primary* sort column (paper: d3d2d1 == highest-
    cardinality column first when col_order = [2, 1, 0]).  ``remaps``
    (optional per-column rank permutations) sort by encoded rank instead of
    original rank — the histogram-aware layout's row order.
    """
    table = np.asarray(table)
    n, d = table.shape
    order = list(range(d)) if col_order is None else list(col_order)
    # np.lexsort: last key is primary
    keys = tuple(reversed(_key_cols(table, order, remaps)))
    return np.lexsort(keys)


def _bit_matrix(table: np.ndarray, encoders: Sequence[ColumnEncoder],
                col_order: Optional[Sequence[int]] = None) -> np.ndarray:
    """(n, L_total) uint8 bit rows of the index under the given encoders."""
    table = np.asarray(table)
    n, d = table.shape
    order = list(range(d)) if col_order is None else list(col_order)
    L_total = sum(encoders[c].L for c in order)
    if L_total > MAX_GRAY_BITS:
        raise ValueError(
            f"Gray sort materializes {L_total} bit columns > {MAX_GRAY_BITS}; "
            "the paper likewise restricts Gray sorting to small indexes")
    bits = np.zeros((n, L_total), dtype=np.uint8)
    off = 0
    for c in order:
        enc = encoders[c]
        codes = enc.codes(table[:, c])  # (n, k)
        rows = np.repeat(np.arange(n), enc.k)
        bits[rows, (codes + off).reshape(-1)] = 1
        off += enc.L
    return bits


def _argsort_bit_rows(bits: np.ndarray) -> np.ndarray:
    """Stable lexicographic argsort of 0/1 rows (MSB = column 0)."""
    packed = np.packbits(bits, axis=1, bitorder="big")
    keys = tuple(packed[:, i] for i in reversed(range(packed.shape[1])))
    return np.lexsort(keys)


def gray_sort(table: np.ndarray, encoders: Sequence[ColumnEncoder],
              col_order: Optional[Sequence[int]] = None) -> np.ndarray:
    """Row permutation of the Gray-code sort of index bit rows (paper §3.2).

    Key identity: treating rows as Gray codes and ordering them equals the
    lexicographic order of their prefix-XOR transforms u_j = b_1 ^ ... ^ b_j
    (the paper's ``impair`` condition), so no B-tree is needed.
    """
    bits = _bit_matrix(table, encoders, col_order)
    u = np.bitwise_xor.accumulate(bits, axis=1)
    return _argsort_bit_rows(u)


def lex_sort_bits(table: np.ndarray, encoders: Sequence[ColumnEncoder],
                  col_order: Optional[Sequence[int]] = None) -> np.ndarray:
    """Row permutation of the plain lexicographic sort of index bit rows."""
    return _argsort_bit_rows(_bit_matrix(table, encoders, col_order))


def random_sort(table: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """`sort --random-sort`: groups identical rows, random group order (O(n))."""
    table = np.asarray(table)
    _, inverse = np.unique(table, axis=0, return_inverse=True)
    n_groups = int(inverse.max()) + 1 if len(inverse) else 0
    group_key = rng.permutation(n_groups)
    return np.argsort(group_key[inverse], kind="stable")


def random_shuffle(table: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    return rng.permutation(len(table))


def block_sort(table: np.ndarray, n_blocks: int,
               col_order: Optional[Sequence[int]] = None) -> np.ndarray:
    """Block-wise sort without merging (paper §4.4: split + sort + cat)."""
    n = len(table)
    perm = np.empty(n, dtype=np.int64)
    bounds = np.linspace(0, n, n_blocks + 1).astype(np.int64)
    for s, e in zip(bounds[:-1], bounds[1:]):
        perm[s:e] = s + lex_sort(table[s:e], col_order)
    return perm


# ---------------------------------------------------------------------------
# External-merge lexicographic sort (paper §4.4).
#
# Block-wise sorting — sort each memory-sized chunk independently and
# concatenate — is what a naive out-of-core sort produces, and the paper shows
# it loses most of the compression benefit (Table 8).  The classical fix is an
# external merge sort: sort chunks into runs, then k-way merge the runs by the
# column-order key, which recovers the *full* lexicographic order and hence
# full-sort compression.
#
# Two run stores are supported.  Without ``spill_dir`` the runs stay in
# memory (the original simulation: run generation + streaming k-way merge
# over run cursors).  With ``spill_dir`` each chunk-sorted run is *written to
# disk* — a key file (packed uint64 scalars, or the raw int64 key columns
# when the key space overflows 64 bits) plus an int64 permutation file,
# reopened as read-only ``np.memmap``s — and the k-way merge reads them back through
# bounded windows of ``merge_block_rows`` keys per run, so the sorter's
# memory ceiling is enforced, not simulated: peak Python-level buffering is
# O(chunk_rows + n_runs * merge_block_rows) regardless of table size, and
# ``SortStats.peak_buffer_bytes`` reports the measured bound.
# ---------------------------------------------------------------------------

def _key_cards(table: np.ndarray, order: Sequence[int],
               remaps=None) -> Optional[List[int]]:
    """Per-column key cardinalities (max+1) over the whole table, or ``None``
    when the combined key space overflows a uint64.

    With ``remaps``, a remapped column's cardinality is the permutation's
    length — a cheap exact bound that avoids re-scanning the (possibly
    memmapped) table through the remap."""
    cards = []
    capacity = 1
    for c in order:
        lo = int(table[:, c].min())
        if lo < 0:
            raise ValueError(f"column {c} has negative rank {lo}")
        r = remaps[c] if remaps is not None else None
        card = len(r) if r is not None else int(table[:, c].max()) + 1
        cards.append(card)
        capacity *= card
    if capacity >= 1 << 64:
        return None
    return cards


def _pack_rows(rows: np.ndarray, order: Sequence[int],
               cards: Sequence[int], remaps=None) -> np.ndarray:
    """Pack each row's sort key into one uint64 using *global* cardinalities
    (so per-chunk keys from different runs compare consistently)."""
    key = np.zeros(len(rows), dtype=np.uint64)
    for col, card in zip(_key_cols(rows, order, remaps), cards):
        key = key * np.uint64(card) + col.astype(np.uint64)
    return key


def _pack_keys(table: np.ndarray, order: Sequence[int],
               remaps=None) -> Optional[np.ndarray]:
    """Pack each row's sort key into one uint64 (None if it would overflow).

    The packed key preserves lexicographic order over ``order``; packing lets
    the merge compare rows with scalar numpy ops instead of Python tuples.
    """
    table = np.asarray(table)
    if len(table) == 0:
        return np.zeros(0, dtype=np.uint64)
    cards = _key_cards(table, order, remaps)
    if cards is None:
        return None
    return _pack_rows(table, order, cards, remaps)


def _merge_runs_packed(keys: List[np.ndarray], runs: List[np.ndarray]) -> np.ndarray:
    """K-way merge of sorted runs by packed scalar key -> global permutation.

    Streaming cursor merge: repeatedly take from the run with the smallest
    head the whole prefix that may precede every other run's head (found by
    binary search), so sorted data with locality advances in large vectorized
    strides.  Ties break by run id, which — with runs cut in row order —
    reproduces the stable ``np.lexsort`` permutation exactly.
    """
    total = sum(len(r) for r in runs)
    out = np.empty(total, dtype=np.int64)
    pos = [0] * len(runs)
    heap = [(int(k[0]), r) for r, k in enumerate(keys) if len(k)]
    heapq.heapify(heap)
    w = 0
    while heap:
        _, r = heapq.heappop(heap)
        if heap:
            nxt_key, nxt_run = heap[0]
            side = "right" if r < nxt_run else "left"
            end = pos[r] + int(np.searchsorted(keys[r][pos[r]:], nxt_key, side=side))
            end = max(end, pos[r] + 1)  # always consume at least the head
        else:
            end = len(keys[r])
        n = end - pos[r]
        out[w:w + n] = runs[r][pos[r]:end]
        w += n
        pos[r] = end
        if end < len(keys[r]):
            heapq.heappush(heap, (int(keys[r][end]), r))
    return out


def _merge_runs_tuples(table: np.ndarray, order: Sequence[int],
                       runs: List[np.ndarray], remaps=None) -> np.ndarray:
    """Fallback merge on Python tuple keys (key space too wide to pack)."""
    def cursor(r: int, run: np.ndarray):
        key_cols = np.stack(_key_cols(table[run], list(order), remaps),
                            axis=1)
        for i, row in enumerate(run):
            yield (tuple(key_cols[i].tolist()), r, int(row))

    merged = heapq.merge(*(cursor(r, run) for r, run in enumerate(runs)))
    return np.fromiter((row for _, _, row in merged), dtype=np.int64,
                       count=sum(len(r) for r in runs))


@dataclass
class SortStats:
    """Accounting for one external sort (filled when passed in).

    ``peak_buffer_bytes`` counts the arrays the sorter itself allocates —
    chunk key/permutation buffers during run generation, per-run merge
    windows and the output block during the merge — i.e. the memory the
    ``chunk_rows`` / ``merge_block_rows`` budget is supposed to bound.  The
    input table (often a caller-owned memmap) and ``np.lexsort``'s internal
    scratch, both O(chunk) on the spill path, are outside it.
    """
    n_runs: int = 0
    spilled_bytes: int = 0
    peak_buffer_bytes: int = 0
    merge_block_rows: int = 0
    # hierarchical-merge passes that reduced the run count before the final
    # merge (0 = every initial run merged in one pass); ``n_runs`` always
    # reports the *initial* run count
    merge_passes: int = 0
    run_files: List[str] = field(default_factory=list)

    def bump(self, n_bytes: int) -> None:
        self.peak_buffer_bytes = max(self.peak_buffer_bytes, int(n_bytes))


class _SpillCursor:
    """Bounded-window reader over one on-disk run.

    Holds at most ``block`` keys in memory at a time (an explicit copy out
    of the key memmap); the permutation memmap is only sliced in ``take``,
    in pieces of at most ``block`` rows.
    """

    __slots__ = ("keys", "perm", "n", "pos", "block", "_w0", "_wkeys")

    def __init__(self, keys_mm: np.ndarray, perm_mm: np.ndarray, block: int):
        assert len(keys_mm) == len(perm_mm)
        self.keys = keys_mm
        self.perm = perm_mm
        self.n = len(keys_mm)
        self.pos = 0
        self.block = max(int(block), 1)
        self._w0 = 0
        self._wkeys = np.empty(0, np.uint64)

    def _window(self, start: int) -> None:
        self._w0 = start
        # a real copy, not a memmap view: the window IS the merge's bounded
        # buffer, and SortStats counts these bytes as allocated
        self._wkeys = np.array(self.keys[start:start + self.block],
                               dtype=np.uint64, copy=True)

    def _local_bound(self, suffix: np.ndarray, bound, side: str) -> int:
        return int(np.searchsorted(suffix, bound, side=side))

    def head(self):
        if not (self._w0 <= self.pos < self._w0 + len(self._wkeys)):
            self._window(self.pos)
        return int(self._wkeys[self.pos - self._w0])

    def scan_until(self, bound, side: str) -> int:
        """First index e >= pos+1 where keys[pos:e] may all precede ``bound``
        (searchsorted semantics per ``side``), scanning window by window."""
        e = self.pos
        if not (self._w0 <= e <= self._w0 + len(self._wkeys)):
            self._window(e)
        while True:
            if e >= self.n:
                return self.n
            if e >= self._w0 + len(self._wkeys):
                self._window(e)
            local = self._local_bound(self._wkeys[e - self._w0:], bound, side)
            e += local
            if e < self._w0 + len(self._wkeys) or e >= self.n:
                return max(e, self.pos + 1)
            # boundary ran off the loaded window: more qualifying keys may
            # follow — slide the window and keep scanning


def _tuple_less(rows: np.ndarray, bound: Tuple[int, ...],
                or_equal: bool) -> np.ndarray:
    """Row-wise lexicographic ``row < bound`` (or <=) over a (w, d) key
    block — the multi-column analogue of a scalar key comparison."""
    less = np.zeros(len(rows), dtype=bool)
    tie = np.ones(len(rows), dtype=bool)
    for j, b in enumerate(bound):
        cj = rows[:, j]
        less |= tie & (cj < b)
        tie &= cj == b
    return less | tie if or_equal else less


class _TupleSpillCursor(_SpillCursor):
    """Spill cursor over *unpacked* key columns (int64, one row per key).

    Used when the combined key space overflows a uint64 so no packed scalar
    key exists: runs spill the raw key columns instead, heads are Python
    tuples (which ``heapq`` orders lexicographically, matching
    ``np.lexsort``), and in-window bounds come from a vectorized row-wise
    lexicographic comparison — the merge logic upstream is unchanged.
    """

    def _window(self, start: int) -> None:
        self._w0 = start
        self._wkeys = np.array(self.keys[start:start + self.block],
                               dtype=np.int64, copy=True)

    def _local_bound(self, suffix: np.ndarray, bound, side: str) -> int:
        # sorted suffix: count of rows preceding ``bound`` IS the insertion
        # point searchsorted would return for the packed key
        return int(np.count_nonzero(
            _tuple_less(suffix, bound, or_equal=side == "right")))

    def head(self):
        if not (self._w0 <= self.pos < self._w0 + len(self._wkeys)):
            self._window(self.pos)
        return tuple(self._wkeys[self.pos - self._w0].tolist())


def _merge_spilled(cursors: List[_SpillCursor],
                   stats: Optional[SortStats] = None,
                   with_keys: bool = False) -> Iterator[np.ndarray]:
    """K-way merge over spilled runs, yielding permutation blocks.

    Same galloping strategy (and exact tie order) as ``_merge_runs_packed``:
    take from the smallest head the whole prefix that may precede every
    other head, but never more than one cursor window at a time is resident
    per run and each yielded block copies at most ``block`` rows.

    ``with_keys`` yields ``(key_block, perm_block)`` pairs instead — the
    producer side of a hierarchical merge pass, which must spill the merged
    keys back to disk for the next pass to merge on.
    """
    heap = [(c.head(), r) for r, c in enumerate(cursors) if c.n]
    heapq.heapify(heap)
    while heap:
        _, r = heapq.heappop(heap)
        c = cursors[r]
        if heap:
            nxt_key, nxt_run = heap[0]
            side = "right" if r < nxt_run else "left"
            end = c.scan_until(nxt_key, side)
        else:
            end = c.n
        pos = c.pos
        while pos < end:
            take = min(end - pos, c.block)
            block = np.array(c.perm[pos:pos + take], dtype=np.int64,
                             copy=True)
            if stats is not None:
                stats.bump(sum(x._wkeys.nbytes for x in cursors)
                           + block.nbytes)
            if with_keys:
                yield np.array(c.keys[pos:pos + take], copy=True), block
            else:
                yield block
            pos += take
        c.pos = end
        if end < c.n:
            heapq.heappush(heap, (c.head(), r))


# runaway-run backstop: with ``merge_fan_in=None`` a hierarchical merge
# still kicks in automatically once this many runs exist, where the
# flat merge's n_runs * merge_block_rows key windows dwarf the chunk budget
_AUTO_MULTIPASS_RUNS = 512


def _resolve_fan_in(merge_fan_in, chunk_rows: int, merge_block_rows: int,
                    n_runs: int) -> Optional[int]:
    """Concrete per-pass fan-in, or ``None`` for the flat single-pass merge.

    ``None`` keeps the classic flat merge unless the run count passes the
    ``_AUTO_MULTIPASS_RUNS`` backstop; ``"auto"`` sizes the fan-in so one
    pass's merge windows fit the chunk budget
    (``chunk_rows // merge_block_rows``); an integer pins it directly.
    """
    if merge_fan_in is None:
        if n_runs <= _AUTO_MULTIPASS_RUNS:
            return None
        merge_fan_in = "auto"
    if merge_fan_in == "auto":
        return max(2, chunk_rows // max(merge_block_rows, 1))
    fan = int(merge_fan_in)
    if fan < 2:
        raise ValueError(f"merge_fan_in must be >= 2, got {merge_fan_in}")
    return fan


def _reduce_runs(cursors: List[_SpillCursor], spill_dir: str, fan_in: int,
                 stats: SortStats) -> List[_SpillCursor]:
    """Hierarchically merge on-disk runs until at most ``fan_in`` remain.

    Each pass merges consecutive groups of ``fan_in`` runs into one new
    on-disk run (keys + permutation, streamed block by block), so no step
    ever holds more than ``fan_in`` merge windows — the multi-pass external
    merge of the classic tape-sort, triggered when
    ``n_runs * merge_block_rows`` key windows would blow the chunk budget.
    Groups stay consecutive and ties break by run id, so the final
    permutation is bit-identical to the flat single-pass merge (and hence
    to ``np.lexsort``).
    """
    pass_id = 0
    while len(cursors) > fan_in:
        pass_id += 1
        stats.merge_passes = pass_id
        nxt: List[_SpillCursor] = []
        for g0 in range(0, len(cursors), fan_in):
            group = cursors[g0:g0 + fan_in]
            if len(group) == 1:
                nxt.append(group[0])
                continue
            stem = os.path.join(spill_dir,
                                f"pass{pass_id:02d}-run-{len(nxt):05d}")
            kpath, ppath = stem + ".keys", stem + ".perm"
            n_rows = sum(c.n for c in group)
            with open(kpath, "wb") as kf, open(ppath, "wb") as pf:
                for kblock, pblock in _merge_spilled(group, stats,
                                                     with_keys=True):
                    kblock.tofile(kf)
                    pblock.tofile(pf)
            stats.run_files += [kpath, ppath]
            block = group[0].block
            perm_mm = np.memmap(ppath, dtype=np.int64, mode="r",
                                shape=(n_rows,))
            if isinstance(group[0], _TupleSpillCursor):
                d_key = group[0].keys.shape[1]
                keys_mm = np.memmap(kpath, dtype=np.int64, mode="r",
                                    shape=(n_rows, d_key))
                nxt.append(_TupleSpillCursor(keys_mm, perm_mm, block))
            else:
                keys_mm = np.memmap(kpath, dtype=np.uint64, mode="r",
                                    shape=(n_rows,))
                nxt.append(_SpillCursor(keys_mm, perm_mm, block))
            stats.spilled_bytes += keys_mm.nbytes + perm_mm.nbytes
        cursors = nxt
    return cursors


def _spill_runs(table: np.ndarray, chunk_rows: int, order: Sequence[int],
                spill_dir: str, merge_block_rows: Optional[int],
                stats: SortStats, merge_fan_in=None,
                remaps=None) -> List[_SpillCursor]:
    """Chunk-sort ``table`` into on-disk runs; return merge cursors.

    Each run is two flat files in ``spill_dir`` — ``run-NNNNN.keys`` and
    ``run-NNNNN.perm`` (global row ids in key order, int64) — reopened as
    read-only memmaps.  Keys are packed uint64 scalars when the combined
    key space fits 64 bits; otherwise the raw key *columns* spill as an
    int64 (rows, d_key) matrix and a ``_TupleSpillCursor`` merges on
    lexicographic row comparisons — wide keys no longer force the in-memory
    path.  The caller owns the directory; run files are left for
    post-mortem inspection and reuse.
    """
    n = len(table)
    cards = _key_cards(table, order, remaps)
    os.makedirs(spill_dir, exist_ok=True)
    cursors: List[_SpillCursor] = []
    n_runs = -(-n // chunk_rows)
    if merge_block_rows is None:
        # split roughly one chunk's worth of key memory across the runs
        merge_block_rows = max(min(chunk_rows, 1024),
                               chunk_rows // max(n_runs, 1))
    stats.merge_block_rows = int(merge_block_rows)
    d_key = len(list(order))
    for run_id, s in enumerate(range(0, n, chunk_rows)):
        chunk = table[s:s + chunk_rows]
        perm_c = lex_sort(chunk, order, remaps)
        if cards is not None:
            keys_c = _pack_rows(np.asarray(chunk)[perm_c], order, cards,
                                remaps)
        else:
            keys_c = np.ascontiguousarray(
                np.stack(_key_cols(np.asarray(chunk)[perm_c], order, remaps),
                         axis=1), dtype=np.int64)
        stats.bump(keys_c.nbytes + perm_c.nbytes)
        kpath = os.path.join(spill_dir, f"run-{run_id:05d}.keys")
        ppath = os.path.join(spill_dir, f"run-{run_id:05d}.perm")
        keys_c.tofile(kpath)
        (s + perm_c).astype(np.int64).tofile(ppath)
        stats.run_files += [kpath, ppath]
        stats.spilled_bytes += keys_c.nbytes + perm_c.nbytes
        del keys_c, perm_c
        rows_run = min(chunk_rows, n - s)
        perm_mm = np.memmap(ppath, dtype=np.int64, mode="r",
                            shape=(rows_run,))
        if cards is not None:
            keys_mm = np.memmap(kpath, dtype=np.uint64, mode="r",
                                shape=(rows_run,))
            cursors.append(_SpillCursor(keys_mm, perm_mm, merge_block_rows))
        else:
            keys_mm = np.memmap(kpath, dtype=np.int64, mode="r",
                                shape=(rows_run, d_key))
            cursors.append(_TupleSpillCursor(keys_mm, perm_mm,
                                             merge_block_rows))
    stats.n_runs = len(cursors)
    fan_in = _resolve_fan_in(merge_fan_in, chunk_rows,
                             stats.merge_block_rows, len(cursors))
    if fan_in is not None and len(cursors) > fan_in:
        cursors = _reduce_runs(cursors, spill_dir, fan_in, stats)
    return cursors


def external_merge_sort_perm(table: np.ndarray, chunk_rows: int,
                             col_order: Optional[Sequence[int]] = None,
                             spill_dir: Optional[str] = None,
                             merge_block_rows: Optional[int] = None,
                             merge_fan_in=None,
                             stats: Optional[SortStats] = None,
                             remaps=None) -> np.ndarray:
    """Row permutation of an external-merge lexicographic sort.

    Equivalent to ``lex_sort`` (bit-identical permutation, including tie
    order) but only ever sorts ``chunk_rows`` rows at a time: chunks become
    sorted runs, then a streaming k-way merge recovers the global order.
    With ``spill_dir`` the runs live on disk as memmapped key/permutation
    files and the merge reads them through ``merge_block_rows``-sized
    windows, so peak buffering is bounded by the chunk/window budget (the
    returned permutation itself is still O(n); use
    ``external_sorted_chunks`` to stream without materializing it).

    ``merge_fan_in`` bounds how many runs any single merge touches:
    ``"auto"`` derives it from the chunk budget, an integer pins it, and
    ``None`` (default) merges flat unless the run count passes the
    ``_AUTO_MULTIPASS_RUNS`` backstop — beyond the bound, hierarchical
    passes reduce the runs on disk first (``SortStats.merge_passes``).
    """
    table = np.asarray(table)
    n, d = table.shape
    if chunk_rows <= 0:
        raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
    order = list(range(d)) if col_order is None else list(col_order)
    if stats is None:
        stats = SortStats()
    if n <= chunk_rows or spill_dir is None:
        if n > chunk_rows:
            runs = []
            for s in range(0, n, chunk_rows):
                chunk = table[s:s + chunk_rows]
                runs.append(s + lex_sort(chunk, order, remaps))
            keys = _pack_keys(table, order, remaps)
            stats.n_runs = len(runs)
            if keys is None:
                return _merge_runs_tuples(table, order, runs, remaps)
            return _merge_runs_packed([keys[r] for r in runs], runs)
        stats.n_runs = 1 if n else 0
        return lex_sort(table, order, remaps)
    cursors = _spill_runs(table, chunk_rows, order, spill_dir,
                          merge_block_rows, stats, merge_fan_in, remaps)
    out = np.empty(n, dtype=np.int64)
    w = 0
    for block in _merge_spilled(cursors, stats):
        out[w:w + len(block)] = block
        w += len(block)
    assert w == n, (w, n)
    return out


def external_sorted_chunks(table: np.ndarray, chunk_rows: int,
                           col_order: Optional[Sequence[int]] = None,
                           out_rows: Optional[int] = None,
                           spill_dir: Optional[str] = None,
                           merge_block_rows: Optional[int] = None,
                           merge_fan_in=None,
                           stats: Optional[SortStats] = None,
                           remaps=None) -> Iterator[np.ndarray]:
    """Yield the externally merge-sorted table in chunks of ``out_rows`` rows.

    The natural producer for ``IndexBuilder.append``: chunks stream out in
    global lexicographic order, so the index gets full-sort compression even
    though no step ever sorted more than ``chunk_rows`` rows.  With
    ``spill_dir`` the chunks stream *straight off the merged on-disk runs* —
    the full permutation is never materialized, so the whole
    sort→build pipeline runs in O(chunk + merge windows + partition) memory.
    """
    step = out_rows or chunk_rows
    if step <= 0:
        raise ValueError(f"out_rows must be positive, got {step}")
    table_arr = np.asarray(table)
    n = len(table_arr)
    if spill_dir is None or n <= chunk_rows:
        perm = external_merge_sort_perm(table, chunk_rows, col_order,
                                        spill_dir=spill_dir,
                                        merge_block_rows=merge_block_rows,
                                        merge_fan_in=merge_fan_in,
                                        stats=stats, remaps=remaps)
        for s in range(0, len(perm), step):
            yield table_arr[perm[s:s + step]]
        return
    if stats is None:
        stats = SortStats()
    d = table_arr.shape[1]
    order = list(range(d)) if col_order is None else list(col_order)
    cursors = _spill_runs(table_arr, chunk_rows, order, spill_dir,
                          merge_block_rows, stats, merge_fan_in, remaps)
    pending: List[np.ndarray] = []
    pending_rows = 0
    for block in _merge_spilled(cursors, stats):
        pending.append(block)
        pending_rows += len(block)
        while pending_rows >= step:
            perm_chunk = np.concatenate(pending) if len(pending) > 1 \
                else pending[0]
            head, tail = perm_chunk[:step], perm_chunk[step:]
            pending = [tail] if len(tail) else []
            pending_rows = len(tail)
            yield table_arr[head]
    if pending_rows:
        yield table_arr[np.concatenate(pending) if len(pending) > 1
                        else pending[0]]


def order_columns(cards: Sequence[int], strategy: str = "card_desc") -> list:
    """Column ordering strategies of §4.3.

    'card_desc' — highest cardinality first (paper's d3d2d1);
    'card_asc'  — lowest first (d1d2d3);
    'freq_aware'— beyond-paper §4.3 remark: lead with the highest-cardinality
                  column whose mean value frequency is >= one word (32), so the
                  leading runs are at least word-long; ties by cardinality.
    """
    cards = list(cards)
    idx = list(range(len(cards)))
    if strategy == "card_desc":
        return sorted(idx, key=lambda c: -cards[c])
    if strategy == "card_asc":
        return sorted(idx, key=lambda c: cards[c])
    raise ValueError(strategy)


def order_columns_freq_aware(table: np.ndarray, cards: Sequence[int],
                             word_bits: int = 32) -> list:
    """Put first the big-cardinality columns whose values still repeat >= w times.

    Implements the paper's §4.3 closing remark ("une dimension n'ayant que des
    valeurs avec une fréquence inférieure à 32 ne devrait sans doute pas servir
    de base au tri") as an executable strategy.

    Delegates to ``layout.advise_order`` — the rule is a pure function of
    (row count, cardinalities), which is exactly why the streaming
    ``LayoutStats`` collector reproduces this order without materializing
    the table.
    """
    from .layout import advise_order
    return advise_order(len(table), cards, word_bits)
