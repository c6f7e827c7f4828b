"""EWAH (Enhanced Word-Aligned Hybrid) compressed bitmaps — faithful codec.

Paper layout (Aouiche, Lemire & Kaser 2008, §2.3), 32-bit words:

  * the stream is a sequence of segments, each = 1 *marker word* followed by
    ``nlit`` verbatim ("dirty"/impropre) words;
  * marker word bit layout (LSB first):
      bit 0        : clean-word type of the run (0 = 0x00000000, 1 = 0xFFFFFFFF)
      bits 1..16   : number of clean words in the run         (16 bits, max 65535)
      bits 17..31  : number of literal words after the run    (15 bits, max 32767)
  * a bitmap always starts with a marker word (paper footnote: purely technical).

Logical ops run in O(runs_1 + runs_2) marker steps with vectorized literal
overlaps, realizing Lemma 2: clean-zero runs skip literal payloads entirely.

Hot path (this module's two execution strategies):

* ``binary_op`` / ``_SegCursor`` — the original per-segment Python cursor
  merge.  Kept verbatim as the *reference oracle*: simple, obviously correct,
  and the target the vectorized path is property-tested against.
* The **run-list path** (default for ``&``/``|``/``^``/``andnot`` and the
  n-ary ``and_many``/``or_many``): each bitmap's marker stream is decoded
  *once* into a ``RunList`` — aligned NumPy arrays of interval ``bounds`` in
  uncompressed word space, per-interval ``kinds`` (clean-0 / clean-1 /
  literal) and a concatenated literal-word pool — memoized on the ``EWAH``
  object.  A logical op aligns the two interval sets with one
  ``union1d``/``searchsorted`` pass, resolves every aligned interval from a
  9-entry kind×kind mode table, gathers/combines literal words with whole-
  array ufuncs, and re-canonicalizes (clean-word resplit + adjacent-run
  merge + marker emission) entirely with vectorized NumPy.  Output words are
  bit-identical to ``binary_op``'s; n-ary reductions fold at the run-list
  level so intermediate results never round-trip through the word codec.
"""
from __future__ import annotations

import numpy as np
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

from repro_torch.kernels import _trace

WORD_BITS = 32
WORD_DTYPE = np.uint32
ALL_ONES = np.uint32(0xFFFFFFFF)
MAX_CLEAN = (1 << 16) - 1  # clean-run words per marker
MAX_LIT = (1 << 15) - 1    # literal words per marker

_CLEAN_SHIFT = 1
_LIT_SHIFT = 17


def make_marker(clean_bit: int, n_clean: int, n_lit: int) -> int:
    assert 0 <= n_clean <= MAX_CLEAN and 0 <= n_lit <= MAX_LIT
    return (clean_bit & 1) | (n_clean << _CLEAN_SHIFT) | (n_lit << _LIT_SHIFT)


def parse_marker(word: int) -> Tuple[int, int, int]:
    word = int(word)
    return word & 1, (word >> _CLEAN_SHIFT) & MAX_CLEAN, (word >> _LIT_SHIFT) & MAX_LIT


# ---------------------------------------------------------------------------
# Segment streams.  A segment is ('run', bit, count) or ('lit', words-array).
# Canonical EWAH emission happens in one place: ``_emit``.
# ---------------------------------------------------------------------------

Run = Tuple[str, int, int]          # ('run', bit, count)
Lit = Tuple[str, np.ndarray]        # ('lit', words)


def _split_literal(words: np.ndarray) -> Iterator:
    """Split a word array into maximal clean runs / literal stretches."""
    n = len(words)
    if n == 0:
        return
    is_clean = (words == 0) | (words == ALL_ONES)
    # group key: -1 literal, 0 clean-zero, 1 clean-one
    key = np.where(is_clean, (words == ALL_ONES).astype(np.int8), np.int8(-1))
    bounds = np.flatnonzero(key[1:] != key[:-1]) + 1
    starts = np.concatenate(([0], bounds))
    ends = np.concatenate((bounds, [n]))
    for s, e in zip(starts, ends):
        if key[s] < 0:
            yield ("lit", words[s:e])
        else:
            yield ("run", int(key[s]), int(e - s))


class EWAH:
    """An EWAH-compressed bitmap over ``n_bits`` bits.

    Instances are immutable; the decoded ``RunList`` (and the popcount) are
    memoized on first use so repeated logical ops against the same bitmap —
    the common case for cached index operands — pay the marker-stream decode
    exactly once.
    """

    __slots__ = ("_words", "n_bits", "_rl", "_popcnt", "_iv", "_cont",
                 "_sizew")

    def __init__(self, words: np.ndarray, n_bits: int):
        self._words = np.asarray(words, dtype=WORD_DTYPE)
        self.n_bits = int(n_bits)
        self._rl: Optional["RunList"] = None
        self._popcnt: Optional[int] = None
        self._iv: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._cont = None
        self._sizew: Optional[int] = None

    @classmethod
    def _from_containers(cls, cont, n_bits: int) -> "EWAH":
        """Container-backed bitmap: EWAH words are emitted lazily, only
        if something actually asks for the marker stream."""
        self = cls.__new__(cls)
        self._words = None
        self.n_bits = int(n_bits)
        self._rl = None
        self._popcnt = None
        self._iv = None
        self._cont = cont
        self._sizew = None
        return self

    @property
    def words(self) -> np.ndarray:
        """Canonical EWAH marker stream (emitted on demand when this
        bitmap is container-backed; bit-identical to the run-list path)."""
        if self._words is None:
            self._words = _rl_emit(self.runlist())
        return self._words

    # -- stats ------------------------------------------------------------
    @property
    def size_words(self) -> int:
        """Compressed size in 32-bit words (the paper's size unit).

        For container-backed bitmaps this is the exact serialized
        container size (directory + payloads), cached so cache-byte
        accounting stays stable across lazy word emission.
        """
        if self._sizew is None:
            if self._words is None and self._cont is not None:
                self._sizew = int(self._cont.size_words)
            else:
                self._sizew = int(len(self.words))
        return self._sizew

    @property
    def size_bytes(self) -> int:
        return self.size_words * 4

    @property
    def n_words_uncompressed(self) -> int:
        return -(-self.n_bits // WORD_BITS)

    def compression_factor(self) -> float:
        """1 - C/N as plotted in the paper's Fig. 4 (→1 == well compressed)."""
        n = max(self.n_words_uncompressed, 1)
        return 1.0 - self.size_words / n

    # -- construction -----------------------------------------------------
    @classmethod
    def from_words(cls, words: np.ndarray, n_bits: int) -> "EWAH":
        """Compress a dense uint32 word array.

        Whole-array passes, no per-segment loop: each word is classified
        clean-zero / clean-one / literal, the kind changes bound the
        canonical ``RunList``'s intervals, and ``_rl_emit`` writes the
        marker stream — word for word ``_emit(_split_literal(words))``.
        The run-list stays memoized on the result, so its first logical
        op, ``count()`` or ``set_intervals()`` decodes nothing.
        """
        words = np.ascontiguousarray(words, dtype=WORD_DTYPE)
        n = len(words)
        if n == 0:
            return _empty_ewah(n_bits)
        one = words == ALL_ONES
        lit = ~(one | (words == 0))
        # 0, 1, 2: KIND_CLEAN0, KIND_CLEAN1, KIND_LIT
        kind = one.view(np.int8) + (lit.view(np.int8) << 1)
        starts = np.flatnonzero(kind[1:] != kind[:-1]) + 1
        bounds = np.empty(len(starts) + 2, np.int64)
        bounds[0], bounds[1:-1], bounds[-1] = 0, starts, n
        kinds = kind[bounds[:-1]]
        lit_len = np.where(kinds == KIND_LIT, np.diff(bounds), 0)
        lit_starts = np.cumsum(lit_len) - lit_len
        _trace.count("ewah.from_words.intervals", len(kinds))
        return _rl_wrap(RunList(bounds, kinds, lit_starts, words[lit]), n_bits)

    @classmethod
    def from_bool(cls, bits: np.ndarray) -> "EWAH":
        from .bitpack import pack_bits
        bits = np.asarray(bits, dtype=bool)
        return cls.from_words(pack_bits(bits), len(bits))

    @classmethod
    def from_positions(cls, positions: np.ndarray, n_bits: int,
                       container: str = "run") -> "EWAH":
        """Build directly from sorted set-bit positions — O(set bits).

        Emits a ``RunList`` directly (no ``_emit`` round-trip): each touched
        word becomes a literal item, gaps between touched words become
        clean-zero runs, and one vectorized canonicalization pass merges /
        reclassifies — so the words come out identical to the historical
        segment path *and* the freshly built bitmap's run-list memo is
        already warm for its first logical op.

        ``container="auto"`` builds Roaring-style hybrid containers
        natively (sparse chunks become position arrays without touching
        the RLE codec — the delta-append path); when every chunk still
        prefers the run form the plain run-list bitmap is returned, so
        fully sorted batch builds are byte-identical either way.
        ``container="run"`` (default) forces today's run-list encoding.
        """
        positions = np.asarray(positions, dtype=np.int64)
        if container == "auto" and n_bits > 0 and positions.size:
            from .containers import (containers_from_positions, worthwhile)
            pos = np.unique(positions)
            cont = containers_from_positions(pos, n_bits)
            if worthwhile(cont):
                return cls._from_containers(cont, n_bits)
            positions = pos
        n_words = -(-n_bits // WORD_BITS)
        if positions.size == 0:
            rl = (_groups_to_runlist(
                np.array([KIND_CLEAN0], np.int8),
                np.array([n_words], np.int64),
                np.zeros(1, WORD_DTYPE)) if n_words else _EMPTY_RUNLIST)
            return _rl_wrap(rl, n_bits)
        word_idx = positions >> 5
        bit_val = np.uint32(1) << (positions & 31).astype(np.uint32)
        # or-reduce duplicate word indices
        uniq, inv = np.unique(word_idx, return_inverse=True)
        vals = np.zeros(len(uniq), dtype=np.uint64)
        np.bitwise_or.at(vals, inv, bit_val.astype(np.uint64))
        vals = vals.astype(WORD_DTYPE)
        m = len(uniq)
        # item stream: [zero-gap?] literal per touched word, then a tail gap;
        # canonicalization merges adjacent words and re-classifies 0xFFFFFFFF
        gap = np.diff(np.concatenate(([-1], uniq))) - 1  # zeros before word i
        has_gap = gap > 0
        tail = n_words - int(uniq[-1]) - 1
        lit_at = np.arange(m) + np.cumsum(has_gap)
        n_items = m + int(has_gap.sum()) + (1 if tail > 0 else 0)
        item_kind = np.full(n_items, KIND_LIT, np.int8)
        item_count = np.ones(n_items, np.int64)
        item_word = np.zeros(n_items, WORD_DTYPE)
        item_word[lit_at] = vals
        gap_at = lit_at[has_gap] - 1
        item_kind[gap_at] = KIND_CLEAN0
        item_count[gap_at] = gap[has_gap]
        if tail > 0:
            item_kind[-1] = KIND_CLEAN0
            item_count[-1] = tail
        return _rl_wrap(_groups_to_runlist(item_kind, item_count, item_word),
                        n_bits)

    # -- decompression ----------------------------------------------------
    def segments(self) -> Iterator:
        """Yield canonical ('run', bit, count) / ('lit', words) segments."""
        w = self.words
        i = 0
        n = len(w)
        while i < n:
            bit, n_clean, n_lit = parse_marker(w[i])
            i += 1
            if n_clean:
                yield ("run", bit, n_clean)
            if n_lit:
                yield ("lit", w[i : i + n_lit])
                i += n_lit

    def to_words(self) -> np.ndarray:
        """Dense uint32 words, filled from the run-list in whole-array
        passes: word for word the ``segments()`` walk.  The run-list is
        the memoized one where there is one, else one cold decode that
        stays memoized."""
        if self._words is None and self._cont is not None:
            # assemble per chunk — dense containers feed the kernels
            # without a marker-stream decode
            from .containers import containers_to_dense
            return containers_to_dense(self._cont)
        rl = self.runlist()
        _trace.count("ewah.to_words.intervals", rl.n_intervals)
        out = _rl_to_words(rl)
        assert len(out) == self.n_words_uncompressed, (
            len(out), self.n_words_uncompressed)
        return out

    def to_bool(self) -> np.ndarray:
        from .bitpack import unpack_bits
        return unpack_bits(self.to_words(), self.n_bits)

    def set_bits(self) -> np.ndarray:
        """Sorted positions of true bits (query result row ids)."""
        words = self.to_words()
        nz = np.flatnonzero(words)
        if nz.size == 0:
            return np.empty(0, dtype=np.int64)
        bits = ((words[nz, None] >> np.arange(32, dtype=np.uint32)) & 1).astype(bool)
        offs = (nz[:, None] << 5) + np.arange(32)
        pos = offs[bits]
        return pos[pos < self.n_bits]

    def runlist(self) -> "RunList":
        """Decoded interval view of this bitmap (memoized; treat read-only)."""
        if self._rl is None:
            if self._words is None and self._cont is not None:
                from .containers import containers_to_runlist
                self._rl = containers_to_runlist(self._cont)
            else:
                _trace.count("ewah.runlist.decodes")
                self._rl = _decode_runlist(self._words)
        return self._rl

    def to_containers(self, model=None, force: bool = False) -> "EWAH":
        """Hybrid-container view of this bitmap (memoized on the object).

        Chunks the run-list and lets the cost model pick array / dense /
        run per chunk.  When no chunk benefits (pure run material — the
        sorted-table case) the containers are discarded unless ``force``
        is set, keeping the plain pipeline free of dispatch overhead.
        Promotion is lazy: ops that mix container-backed and plain
        operands call this with ``force=True`` on first use.
        """
        if self._cont is not None or self.n_words_uncompressed == 0:
            return self
        from .containers import runlist_to_containers, resolve_cutoff, \
            worthwhile
        cont = runlist_to_containers(self.runlist(), self.n_bits,
                                     resolve_cutoff(model))
        if force or worthwhile(cont):
            self._cont = cont
        return self

    def container_summary(self) -> str:
        """'run' | 'array' | 'dense' | 'mixed' | 'empty' | 'full' | 'ewah'
        — what actually backs this bitmap (cache/stats classification)."""
        if self._cont is None:
            return "ewah"
        return self._cont.type_summary()

    def count(self) -> int:
        """Number of set bits (popcount), ignoring padding bits.

        Computed in the compressed domain from the run-list: clean-one runs
        contribute ``32 * length`` without materializing words, literal words
        are popcounted in one vectorized pass (``np.bitwise_count`` when
        available, the byte lookup table ``POPCOUNT8`` otherwise).
        Memoized — selectivity estimation hits this repeatedly.
        """
        if self.n_bits == 0:
            return 0
        if self._popcnt is None and self._rl is None \
                and self._cont is not None:
            # chunk directory: O(n_chunks), no payload access
            self._popcnt = self._cont.count()
        if self._popcnt is None:
            rl = self.runlist()
            lens = np.diff(rl.bounds)
            total = 32 * int(lens[rl.kinds == KIND_CLEAN1].sum())
            total += _popcount_words(rl.lits)
            pad = self.n_words_uncompressed * WORD_BITS - self.n_bits
            if pad and len(rl.kinds):
                k = int(rl.kinds[-1])
                last = (ALL_ONES if k == KIND_CLEAN1 else np.uint32(0)) \
                    if k != KIND_LIT else rl.lits[-1]
                total -= int(bin(int(last) >> (32 - pad)).count("1"))
            self._popcnt = total
        return self._popcnt

    def and_count(self, other: "EWAH") -> int:
        """Popcount of ``self & other`` without materializing the result.

        The pairwise aggregation kernel — the executor's group-by path uses
        it for literal-heavy bitmaps, where the batched interval-coverage
        kernel (``set_intervals``) would expand toward one interval per set
        bit: the two run-lists are aligned once, clean×clean overlaps
        contribute arithmetically, and only the genuinely-literal overlaps
        are ANDed and popcounted — no output run-list, no marker
        re-emission, no row materialization.  Cost is O(runs_a + runs_b)
        whole-array ops.
        """
        assert self.n_bits == other.n_bits, (self.n_bits, other.n_bits)
        if self.n_bits == 0 or self.n_words_uncompressed == 0:
            return 0
        if self._cont is not None or other._cont is not None:
            from .containers import and_count_containers
            return and_count_containers(
                self.to_containers(force=True)._cont,
                other.to_containers(force=True)._cont)
        ra, rb = self.runlist(), other.runlist()
        bounds = np.union1d(ra.bounds, rb.bounds)
        left = bounds[:-1]
        lens = np.diff(bounds)
        ia = np.searchsorted(ra.bounds, left, side="right") - 1
        ib = np.searchsorted(rb.bounds, left, side="right") - 1
        ka = ra.kinds[ia]
        kb = rb.kinds[ib]
        total = 32 * int(lens[(ka == KIND_CLEAN1) & (kb == KIND_CLEAN1)]
                         .sum())
        # literal vs clean-one: the literal slice passes through unchanged
        for msk, rl, idx in (((ka == KIND_CLEAN1) & (kb == KIND_LIT), rb, ib),
                             ((ka == KIND_LIT) & (kb == KIND_CLEAN1), ra, ia)):
            if msk.any():
                off = (rl.lit_starts[idx[msk]]
                       + (left[msk] - rl.bounds[idx[msk]]))
                total += _popcount_words(rl.lits[_ranges(off, lens[msk])])
        msk = (ka == KIND_LIT) & (kb == KIND_LIT)
        if msk.any():
            aoff = ra.lit_starts[ia[msk]] + (left[msk] - ra.bounds[ia[msk]])
            boff = rb.lit_starts[ib[msk]] + (left[msk] - rb.bounds[ib[msk]])
            total += _popcount_words(ra.lits[_ranges(aoff, lens[msk])]
                                     & rb.lits[_ranges(boff, lens[msk])])
        pad = self.n_words_uncompressed * WORD_BITS - self.n_bits
        if pad:
            last = _rl_last_word(ra) & _rl_last_word(rb)
            total -= int(bin(last >> (WORD_BITS - pad)).count("1"))
        return total

    def set_intervals(self) -> Tuple[np.ndarray, np.ndarray]:
        """Maximal runs of set bits as sorted ``(starts, ends)`` arrays
        (half-open bit positions, clipped to ``n_bits``).

        The aggregation engine's interval view of a bitmap: clean-one runs
        map to intervals directly and only literal words expand their set
        bits, so on sorted tables (few long runs per bitmap) the interval
        list stays tiny while ``sum(ends - starts) == count()`` always
        holds.  Memoized like the run-list; treat the arrays as read-only.
        """
        if self._iv is None:
            rl = self.runlist()
            lens = np.diff(rl.bounds)
            c1 = rl.kinds == KIND_CLEAN1
            starts = (rl.bounds[:-1][c1] * WORD_BITS).astype(np.int64)
            ends = (rl.bounds[1:][c1] * WORD_BITS).astype(np.int64)
            lm = rl.kinds == KIND_LIT
            if lm.any():
                wpos = _ranges(rl.bounds[:-1][lm], lens[lm])
                bits = ((rl.lits[:, None]
                         >> np.arange(WORD_BITS, dtype=np.uint32)) & 1) \
                    .astype(bool)
                pos = ((wpos[:, None] << 5) + np.arange(WORD_BITS))[bits]
                starts = np.concatenate((starts, pos))
                ends = np.concatenate((ends, pos + 1))
                order = np.argsort(starts, kind="stable")
                starts, ends = starts[order], ends[order]
            if len(starts):
                # coalesce touching neighbours (a clean-one run flush against
                # set bits of an adjacent literal word is one logical run)
                new = np.concatenate(([True], starts[1:] > ends[:-1]))
                gs = starts[new]
                last = np.concatenate((np.flatnonzero(new)[1:] - 1,
                                       [len(ends) - 1]))
                ge = np.minimum(ends[last], self.n_bits)
                keep = gs < ge
                self._iv = (gs[keep], ge[keep])
            else:
                self._iv = (np.empty(0, np.int64), np.empty(0, np.int64))
        return self._iv

    # -- structural ops (compressed domain) --------------------------------
    def pad_to(self, n_bits: int) -> "EWAH":
        """This bitmap extended to ``n_bits`` with clear bits (O(runs)).

        Used by the live-ingest layer: a tombstone built over an older,
        shorter delta stays valid for a grown delta because the appended
        rows are live (their tombstone bits must read 0).  If the new length
        fits the existing word count the words are reused verbatim — pad
        bits past ``n_bits`` are guaranteed clear by the codec invariant —
        otherwise a clean-zero run covers the new words.
        """
        n_bits = int(n_bits)
        if n_bits < self.n_bits:
            raise ValueError(f"pad_to cannot shrink: {n_bits} < {self.n_bits}")
        if n_bits == self.n_bits:
            return self
        extra = -(-n_bits // WORD_BITS) - self.n_words_uncompressed
        if extra == 0:
            return EWAH(self.words, n_bits)
        rl = self.runlist()
        if len(rl.kinds) and rl.kinds[-1] == KIND_CLEAN0:
            bounds = rl.bounds.copy()
            bounds[-1] += extra
            out = RunList(bounds, rl.kinds, rl.lit_starts, rl.lits)
        else:
            out = RunList(np.append(rl.bounds, rl.bounds[-1] + extra),
                          np.append(rl.kinds, np.int8(KIND_CLEAN0)),
                          np.append(rl.lit_starts, len(rl.lits)), rl.lits)
        return _rl_wrap(out, n_bits)

    def slice_bits(self, start: int, stop: int) -> "EWAH":
        """Bits ``[start, stop)`` as a new bitmap; ``start`` must be
        word-aligned (32-bit boundary) so the slice is a pure run-list clip
        with no bit shifting — the primitive behind store-file re-sharding.

        Cost is O(runs overlapping the slice): interval bounds shift left
        by whole words, literal words are gathered from the pool, and the
        tail word is masked when ``stop`` is ragged (pad bits stay clear).
        """
        start, stop = int(start), int(stop)
        if start % WORD_BITS:
            raise ValueError(f"slice start {start} not on a 32-bit boundary")
        if not 0 <= start <= stop <= self.n_words_uncompressed * WORD_BITS:
            raise ValueError(f"slice [{start}, {stop}) out of range for "
                             f"{self.n_bits} bits")
        n_bits = stop - start
        if n_bits == 0:
            return _rl_wrap(_EMPTY_RUNLIST, 0)
        w0 = start // WORD_BITS
        out_words = -(-n_bits // WORD_BITS)
        w1 = w0 + out_words
        rl = self.runlist()
        i0 = int(np.searchsorted(rl.bounds, w0, side="right")) - 1
        i1 = int(np.searchsorted(rl.bounds, w1, side="left"))
        bounds = rl.bounds[i0:i1 + 1].astype(np.int64, copy=True)
        bounds[0] = w0
        bounds[-1] = w1
        kinds = rl.kinds[i0:i1]
        lens = np.diff(bounds)
        lit_mask = kinds == KIND_LIT
        src_off = (rl.lit_starts[i0:i1][lit_mask]
                   + (bounds[:-1][lit_mask] - rl.bounds[i0:i1][lit_mask]))
        lits = rl.lits[_ranges(src_off, lens[lit_mask])]
        items_per = np.where(lit_mask, lens, 1)
        item_kind = np.repeat(kinds, items_per)
        item_count = np.where(item_kind == KIND_LIT, 1,
                              np.repeat(lens, items_per))
        item_word = np.zeros(len(item_kind), WORD_DTYPE)
        item_word[item_kind == KIND_LIT] = lits
        pad = out_words * WORD_BITS - n_bits
        if pad:
            tail_mask = np.uint32((1 << (WORD_BITS - pad)) - 1)
            k = int(item_kind[-1])
            if k == KIND_LIT:
                item_word[-1] &= tail_mask
            elif k == KIND_CLEAN1:
                # split the masked final word off its clean-one run
                if item_count[-1] > 1:
                    item_count[-1] -= 1
                    item_kind = np.append(item_kind, np.int8(KIND_LIT))
                    item_count = np.append(item_count, np.int64(1))
                    item_word = np.append(item_word, ALL_ONES & tail_mask)
                else:
                    item_kind[-1] = KIND_LIT
                    item_word[-1] = ALL_ONES & tail_mask
        return _rl_wrap(_groups_to_runlist(item_kind, item_count, item_word),
                        n_bits)

    # -- logical ops (compressed domain, Lemma 2) --------------------------
    def __invert__(self) -> "EWAH":
        """Bitwise complement over ``n_bits`` (padding bits stay clear).

        Runs on the run-list: clean intervals flip kind, the literal pool is
        inverted in one ufunc pass, and only the final word needs care —
        after complementing, the pad bits past ``n_bits`` would read 1, so
        the last item is masked (and re-canonicalized if it comes out
        clean).  Like the binary ops, the result is emitted from the
        run-list directly, so the complement's memoized decode is warm.
        """
        n_words = self.n_words_uncompressed
        if n_words == 0:
            return _rl_wrap(_EMPTY_RUNLIST, self.n_bits)
        pad = n_words * WORD_BITS - self.n_bits
        tail_mask = np.uint32((1 << (WORD_BITS - pad)) - 1) if pad else ALL_ONES

        rl = self.runlist()
        flipped = np.where(rl.kinds == KIND_CLEAN0, np.int8(KIND_CLEAN1),
                           np.where(rl.kinds == KIND_CLEAN1,
                                    np.int8(KIND_CLEAN0), rl.kinds))
        lens = np.diff(rl.bounds)
        is_lit = flipped == KIND_LIT
        items_per = np.where(is_lit, lens, 1)
        item_kind = np.repeat(flipped, items_per)
        item_count = np.where(item_kind == KIND_LIT, 1,
                              np.repeat(lens, items_per))
        item_word = np.zeros(len(item_kind), WORD_DTYPE)
        item_word[item_kind == KIND_LIT] = np.bitwise_not(rl.lits)
        if pad:
            # mask the final word: split it off its run if it was clean
            k = int(item_kind[-1])
            if k == KIND_LIT:
                item_word[-1] &= tail_mask
            else:
                word = (ALL_ONES if k == KIND_CLEAN1 else np.uint32(0)) \
                    & tail_mask
                if item_count[-1] > 1:
                    item_count[-1] -= 1
                    item_kind = np.append(item_kind, np.int8(KIND_LIT))
                    item_count = np.append(item_count, np.int64(1))
                    item_word = np.append(item_word, word)
                else:
                    item_kind[-1] = KIND_LIT
                    item_count[-1] = 1
                    item_word[-1] = word
        return _rl_wrap(_groups_to_runlist(item_kind, item_count, item_word),
                        self.n_bits)

    def __and__(self, other: "EWAH") -> "EWAH":
        return vec_binary_op(self, other, "and")

    def __or__(self, other: "EWAH") -> "EWAH":
        return vec_binary_op(self, other, "or")

    def __xor__(self, other: "EWAH") -> "EWAH":
        return vec_binary_op(self, other, "xor")

    def andnot(self, other: "EWAH") -> "EWAH":
        return vec_binary_op(self, other, "andnot")

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, EWAH)
            and self.n_bits == other.n_bits
            and np.array_equal(self.to_words(), other.to_words())
        )

    def __reduce__(self):
        # pickle only the compressed words: memoized decodes are cheap to
        # rebuild and would bloat cross-process result transfers
        return (EWAH, (self.words, self.n_bits))

    def __repr__(self) -> str:
        return f"EWAH(n_bits={self.n_bits}, words={self.size_words}/{self.n_words_uncompressed})"


# ---------------------------------------------------------------------------
# Canonical emitter: segment stream -> EWAH word stream.
# ---------------------------------------------------------------------------

def _emit(segs: Iterator) -> np.ndarray:
    """Encode a (possibly non-canonical) segment stream into EWAH words.

    Merges adjacent same-bit runs, re-splits literal arrays containing clean
    words, and honours the MAX_CLEAN / MAX_LIT marker limits.
    """
    out: List[np.ndarray] = []
    # pending state
    run_bit, run_cnt = 0, 0
    lits: List[np.ndarray] = []

    def flush(next_run_bit=0):
        nonlocal run_bit, run_cnt, lits
        if run_cnt == 0 and not lits:
            return
        nlit_total = sum(len(a) for a in lits)
        lit_cat = np.concatenate(lits) if lits else np.empty(0, WORD_DTYPE)
        c, l = run_cnt, 0
        # first marker carries as much of the run as fits, then literals
        pos = 0
        while True:
            take_c = min(c, MAX_CLEAN)
            c -= take_c
            if c > 0:
                out.append(np.array([make_marker(run_bit, take_c, 0)], WORD_DTYPE))
                continue
            take_l = min(nlit_total - pos, MAX_LIT)
            out.append(np.array([make_marker(run_bit, take_c, take_l)], WORD_DTYPE))
            if take_l:
                out.append(lit_cat[pos : pos + take_l])
                pos += take_l
            if pos >= nlit_total:
                break
            # more literals: continue with empty run markers
            run_bit = 0
            c = 0
        run_bit, run_cnt, lits = next_run_bit, 0, []

    started = False
    pending_run_open = True  # can still extend the run (no literals yet)
    for seg in segs:
        if seg[0] == "run":
            _, bit, cnt = seg
            if cnt <= 0:
                continue
            if pending_run_open and (run_cnt == 0 or bit == run_bit):
                run_bit = bit if run_cnt == 0 else run_bit
                run_cnt += cnt
            else:
                flush()
                pending_run_open = True
                run_bit, run_cnt = bit, cnt
            started = True
        else:
            arr = np.asarray(seg[1], dtype=WORD_DTYPE)
            if len(arr) == 0:
                continue
            # re-split: literal arrays may contain clean words
            for sub in _split_literal(arr):
                if sub[0] == "run":
                    if pending_run_open and (run_cnt == 0 or sub[1] == run_bit):
                        run_bit = sub[1] if run_cnt == 0 else run_bit
                        run_cnt += sub[2]
                    else:
                        flush()
                        pending_run_open = True
                        run_bit, run_cnt = sub[1], sub[2]
                else:
                    lits.append(sub[1])
                    pending_run_open = False
            started = True
    flush()
    if not out or not started:
        out = [np.array([make_marker(0, 0, 0)], WORD_DTYPE)]
    return np.concatenate(out)


# ---------------------------------------------------------------------------
# Compressed-domain binary ops.
# ---------------------------------------------------------------------------

class _SegCursor:
    """Cursor over a bitmap's canonical segments supporting partial takes."""

    def __init__(self, bm: EWAH):
        self._it = bm.segments()
        self.kind = None   # 'run' | 'lit' | None (exhausted)
        self.bit = 0
        self.remaining = 0
        self.lit: np.ndarray | None = None
        self.lit_pos = 0
        self._advance()

    def _advance(self):
        for seg in self._it:
            if seg[0] == "run":
                if seg[2] <= 0:
                    continue
                self.kind, self.bit, self.remaining = "run", seg[1], seg[2]
                self.lit = None
                return
            else:
                if len(seg[1]) == 0:
                    continue
                self.kind, self.lit, self.lit_pos = "lit", seg[1], 0
                self.remaining = len(seg[1])
                return
        self.kind = None
        self.remaining = 0

    def take(self, n: int):
        """Consume n words; return ('run', bit) or ('lit', words)."""
        assert self.kind is not None and n <= self.remaining
        if self.kind == "run":
            res = ("run", self.bit, n)
        else:
            res = ("lit", self.lit[self.lit_pos : self.lit_pos + n])
            self.lit_pos += n
        self.remaining -= n
        if self.remaining == 0:
            self._advance()
        return res


_NPOP = {
    "and": np.bitwise_and,
    "or": np.bitwise_or,
    "xor": np.bitwise_xor,
    "andnot": lambda a, b: np.bitwise_and(a, np.bitwise_not(b)),
}


def _op_run_run(op: str, a: int, b: int) -> int:
    if op == "and":
        return a & b
    if op == "or":
        return a | b
    if op == "xor":
        return a ^ b
    return a & (1 - b)


def _op_run_lit(op: str, bit: int, lit: np.ndarray, lit_is_b: bool):
    """Combine a clean run (value=bit) against literal words."""
    if op == "and":
        return ("lit", lit) if bit else ("run", 0)
    if op == "or":
        return ("run", 1) if bit else ("lit", lit)
    if op == "xor":
        return ("lit", np.bitwise_not(lit)) if bit else ("lit", lit)
    # andnot: A & ~B
    if lit_is_b:  # run is A
        return ("lit", np.bitwise_not(lit)) if bit else ("run", 0)
    else:         # run is B, lit is A
        return ("run", 0) if bit else ("lit", lit)


def binary_op(a: EWAH, b: EWAH, op: str) -> EWAH:
    """Compressed-domain logical op in O(runs_a + runs_b) merge steps."""
    assert a.n_bits == b.n_bits, (a.n_bits, b.n_bits)
    ca, cb = _SegCursor(a), _SegCursor(b)

    def segs():
        while ca.kind is not None and cb.kind is not None:
            n = min(ca.remaining, cb.remaining)
            sa = ca.take(n)
            sb = cb.take(n)
            if sa[0] == "run" and sb[0] == "run":
                yield ("run", _op_run_run(op, sa[1], sb[1]), n)
            elif sa[0] == "run":
                kind, val = _op_run_lit(op, sa[1], sb[1], lit_is_b=True)
                yield (kind, val, n) if kind == "run" else (kind, val)
            elif sb[0] == "run":
                kind, val = _op_run_lit(op, sb[1], sa[1], lit_is_b=False)
                yield (kind, val, n) if kind == "run" else (kind, val)
            else:
                yield ("lit", _NPOP[op](sa[1], sb[1]))

    return EWAH(_emit(segs()), a.n_bits)


# ---------------------------------------------------------------------------
# Vectorized run-list representation (the production hot path).
#
# A RunList is the fully-aligned decode of a bitmap: ``bounds`` splits the
# uncompressed word space [0, n_words) into intervals; interval i covers
# words [bounds[i], bounds[i+1]) and is either a clean-zero run, a clean-one
# run, or a literal stretch whose words live at
# ``lits[lit_starts[i] : lit_starts[i] + length]``.  Canonical invariants:
# adjacent intervals differ in kind and literal stretches contain no clean
# words — so a RunList maps 1:1 onto canonical EWAH marker output.
# ---------------------------------------------------------------------------

KIND_CLEAN0 = 0
KIND_CLEAN1 = 1
KIND_LIT = 2

_HAS_BITWISE_COUNT = hasattr(np, "bitwise_count")

# byte-wise popcount lookup: the fallback when NumPy lacks ``bitwise_count``
# (numpy < 2.0)
POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint8)


def _popcount_words(words: np.ndarray) -> int:
    """Popcount a uint32 array in one vectorized pass."""
    if len(words) == 0:
        return 0
    if _HAS_BITWISE_COUNT:
        return int(np.bitwise_count(words).sum(dtype=np.int64))
    return int(POPCOUNT8[np.ascontiguousarray(words).view(np.uint8)]
               .sum(dtype=np.int64))


@dataclass(frozen=True, eq=False)
class RunList:
    """Aligned interval decode of one EWAH bitmap (see section comment)."""
    bounds: np.ndarray      # int64 (m+1,): 0 = b[0] < ... < b[m] = n_words
    kinds: np.ndarray       # int8  (m,):   KIND_CLEAN0 | KIND_CLEAN1 | KIND_LIT
    lit_starts: np.ndarray  # int64 (m,):   offset into ``lits`` (lit intervals)
    lits: np.ndarray        # uint32 pool of literal words, interval order

    @property
    def n_intervals(self) -> int:
        return len(self.kinds)

    @property
    def n_words(self) -> int:
        return int(self.bounds[-1])


_EMPTY_RUNLIST = RunList(np.zeros(1, np.int64), np.empty(0, np.int8),
                         np.empty(0, np.int64), np.empty(0, WORD_DTYPE))


def _groups_to_runlist(item_kind: np.ndarray, item_count: np.ndarray,
                       item_word: np.ndarray) -> RunList:
    """Canonicalize an item stream into a RunList.

    Items are (kind, count[, word]) triples where literal items carry exactly
    one word each.  Literal words that are secretly clean (0x0 / 0xFFFFFFFF)
    are reclassified, then adjacent same-kind items merge into maximal
    intervals — the vectorized equivalent of ``_split_literal`` + ``_emit``'s
    run merging.
    """
    if len(item_kind) == 0:
        return _EMPTY_RUNLIST
    is_lit = item_kind == KIND_LIT
    w = item_word
    k = np.where(is_lit & (w == 0), np.int8(KIND_CLEAN0),
                 np.where(is_lit & (w == ALL_ONES), np.int8(KIND_CLEAN1),
                          item_kind)).astype(np.int8)
    starts = np.concatenate(([0], np.flatnonzero(k[1:] != k[:-1]) + 1))
    gkind = k[starts]
    gcount = np.add.reduceat(item_count, starts)
    lits = np.ascontiguousarray(w[k == KIND_LIT])
    bounds = np.concatenate(([0], np.cumsum(gcount))).astype(np.int64)
    lit_len = np.where(gkind == KIND_LIT, gcount, 0)
    lit_starts = (np.concatenate(([0], np.cumsum(lit_len)))[:-1]
                  .astype(np.int64))
    return RunList(bounds, gkind, lit_starts, lits)


def _rl_last_word(rl: RunList) -> int:
    """Value of the final uncompressed word of a run-list (pad handling)."""
    if not len(rl.kinds):
        return 0
    k = int(rl.kinds[-1])
    if k == KIND_LIT:
        return int(rl.lits[-1])
    return 0xFFFFFFFF if k == KIND_CLEAN1 else 0


def _marker_positions(words: np.ndarray) -> np.ndarray:
    """Positions of the marker words in a compressed stream, by pointer
    jumping — no per-marker Python loop.

    Markers form a chain ``p_0 = 0, p_{i+1} = p_i + 1 + nlit(p_i)``.  The
    successor function J (defined over every word position; garbage entries
    at literal positions are never consulted) is repeatedly squared — J,
    J², J⁴, … — and each round doubles the known chain prefix, so the whole
    chain is recovered in O(log n_markers) rounds of whole-array work.
    """
    n = len(words)
    nlit = (words >> np.uint32(_LIT_SHIFT)).astype(np.int64)
    jump = np.minimum(np.arange(n, dtype=np.int64) + 1 + nlit, n)
    jump = np.append(jump, n)  # J[n] = n: past-the-end is a fixed point
    mpos = np.zeros(1, dtype=np.int64)
    while True:
        nxt = jump[mpos]
        nxt = nxt[nxt < n]
        if nxt.size == 0:
            return mpos
        # chain entries are strictly increasing, so the newly reached
        # markers extend the known prefix in order with no duplicates
        mpos = np.concatenate((mpos, nxt))
        jump = jump[jump]


def _decode_runlist(words: np.ndarray) -> RunList:
    """Marker stream -> RunList, fully vectorized.

    The marker chain is recovered by the pointer-jumping pass above, marker
    fields and literal pools are gathered with whole-array indexing, and a
    single canonicalization pass merges/reclassifies — the historical
    per-marker Python loop is gone, which is what cold decodes of
    fragmented, memory-mapped bitmaps used to pay for.
    """
    n = len(words)
    if n == 0:
        return _EMPTY_RUNLIST
    mpos = _marker_positions(words)
    mk = np.asarray(words[mpos], dtype=WORD_DTYPE)
    bits = (mk & np.uint32(1)).astype(np.int8)
    nc = ((mk >> np.uint32(_CLEAN_SHIFT)) & np.uint32(MAX_CLEAN)) \
        .astype(np.int64)
    nl = (mk >> np.uint32(_LIT_SHIFT)).astype(np.int64)
    has_c = nc > 0
    has_l = nl > 0
    per = has_c.astype(np.int64) + has_l.astype(np.int64)
    n_segs = int(per.sum())
    if n_segs == 0:
        return _EMPTY_RUNLIST
    base = np.cumsum(per) - per  # first segment slot of each marker
    seg_kind = np.empty(n_segs, np.int8)
    seg_count = np.empty(n_segs, np.int64)
    ci = base[has_c]
    seg_kind[ci] = bits[has_c]
    seg_count[ci] = nc[has_c]
    li = base[has_l] + has_c[has_l]
    seg_kind[li] = KIND_LIT
    seg_count[li] = nl[has_l]
    lits = (np.asarray(words[_ranges(mpos[has_l] + 1, nl[has_l])],
                       dtype=WORD_DTYPE)
            if has_l.any() else np.empty(0, WORD_DTYPE))
    # expand literal stretches to per-word items for canonicalization
    is_lit = seg_kind == KIND_LIT
    items_per = np.where(is_lit, seg_count, 1)
    item_kind = np.repeat(seg_kind, items_per)
    item_count = np.where(item_kind == KIND_LIT, 1,
                          np.repeat(seg_count, items_per))
    item_word = np.zeros(len(item_kind), WORD_DTYPE)
    item_word[item_kind == KIND_LIT] = lits
    return _groups_to_runlist(item_kind, item_count, item_word)


def _ranges(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenate [s, s+len) index ranges: vectorized multi-slice gather."""
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, np.int64)
    cum0 = np.concatenate(([0], np.cumsum(lens)[:-1]))
    return np.repeat(starts - cum0, lens) + np.arange(total)


def _rl_to_words(rl: RunList) -> np.ndarray:
    """RunList -> dense words: clean-one intervals set, literal intervals
    scattered from the pool, the rest zero."""
    out = np.zeros(rl.n_words, WORD_DTYPE)
    lens = np.diff(rl.bounds)
    c1 = rl.kinds == KIND_CLEAN1
    out[_ranges(rl.bounds[:-1][c1], lens[c1])] = ALL_ONES
    lm = rl.kinds == KIND_LIT
    out[_ranges(rl.bounds[:-1][lm], lens[lm])] = rl.lits
    return out


# per-interval resolution modes for an aligned (kind_a, kind_b) pair
_MODE_COPY_A, _MODE_COPY_B, _MODE_INV_A, _MODE_INV_B, _MODE_COMBINE = 2, 3, 4, 5, 6

# mode = TABLE[op][kind_a * 3 + kind_b]; entries 0/1 are clean results
_MODE_TABLE = {
    "and":    np.array([0, 0, 0, 0, 1, 3, 0, 2, 6], np.int8),
    "or":     np.array([0, 1, 3, 1, 1, 1, 2, 1, 6], np.int8),
    "xor":    np.array([0, 1, 3, 1, 0, 5, 2, 4, 6], np.int8),
    "andnot": np.array([0, 0, 0, 1, 0, 5, 2, 0, 6], np.int8),
}


def _rl_binary(ra: RunList, rb: RunList, op: str) -> RunList:
    """Aligned-interval logical op: RunList x RunList -> canonical RunList."""
    bounds = np.union1d(ra.bounds, rb.bounds)
    left = bounds[:-1]
    lens = np.diff(bounds)
    ia = np.searchsorted(ra.bounds, left, side="right") - 1
    ib = np.searchsorted(rb.bounds, left, side="right") - 1
    ka = ra.kinds[ia].astype(np.int64)
    kb = rb.kinds[ib].astype(np.int64)
    mode = _MODE_TABLE[op][ka * 3 + kb]

    # literal source offsets (valid only where that side is literal)
    a_off = np.zeros(len(mode), np.int64)
    sel = ka == KIND_LIT
    a_off[sel] = ra.lit_starts[ia[sel]] + (left[sel] - ra.bounds[ia[sel]])
    b_off = np.zeros(len(mode), np.int64)
    sel = kb == KIND_LIT
    b_off[sel] = rb.lit_starts[ib[sel]] + (left[sel] - rb.bounds[ib[sel]])

    is_lit = mode >= _MODE_COPY_A
    out_lens = np.where(is_lit, lens, 0)
    dst0 = np.concatenate(([0], np.cumsum(out_lens)))[:-1]
    out_lits = np.empty(int(out_lens.sum()), WORD_DTYPE)
    for m, off, pool, inv in ((_MODE_COPY_A, a_off, ra.lits, False),
                              (_MODE_INV_A, a_off, ra.lits, True),
                              (_MODE_COPY_B, b_off, rb.lits, False),
                              (_MODE_INV_B, b_off, rb.lits, True)):
        msk = mode == m
        if msk.any():
            src = pool[_ranges(off[msk], lens[msk])]
            out_lits[_ranges(dst0[msk], lens[msk])] = \
                np.bitwise_not(src) if inv else src
    msk = mode == _MODE_COMBINE
    if msk.any():
        av = ra.lits[_ranges(a_off[msk], lens[msk])]
        bv = rb.lits[_ranges(b_off[msk], lens[msk])]
        out_lits[_ranges(dst0[msk], lens[msk])] = _NPOP[op](av, bv)

    items_per = np.where(is_lit, lens, 1)
    item_kind = np.repeat(np.where(is_lit, np.int8(KIND_LIT),
                                   mode).astype(np.int8), items_per)
    item_count = np.where(item_kind == KIND_LIT, 1, np.repeat(lens, items_per))
    item_word = np.zeros(len(item_kind), WORD_DTYPE)
    item_word[item_kind == KIND_LIT] = out_lits
    return _groups_to_runlist(item_kind, item_count, item_word)


def _rl_and_many(rls: Sequence[RunList]) -> RunList:
    """One-pass k-way AND: intersect interval coverage across *all* operands.

    The pairwise fold aligns, resolves and re-canonicalizes k-1 times; this
    merges every operand's bounds once, classifies each aligned interval in
    one shot (any clean-zero operand → zero; all clean-one → one; else a
    literal AND that starts from all-ones and folds each literal operand in
    with a whole-array ufunc), and canonicalizes a single time at the end.
    """
    bounds = np.unique(np.concatenate([rl.bounds for rl in rls]))
    left = bounds[:-1]
    lens = np.diff(bounds)
    m = len(left)
    if m == 0:
        return _EMPTY_RUNLIST
    # per-operand aligned interval ids and kinds
    idxs = [np.searchsorted(rl.bounds, left, side="right") - 1 for rl in rls]
    kinds = [rl.kinds[i] for rl, i in zip(rls, idxs)]
    any_zero = np.zeros(m, bool)
    all_one = np.ones(m, bool)
    for k in kinds:
        any_zero |= k == KIND_CLEAN0
        all_one &= k == KIND_CLEAN1
    out_kind = np.where(any_zero, np.int8(KIND_CLEAN0),
                        np.where(all_one, np.int8(KIND_CLEAN1),
                                 np.int8(KIND_LIT)))
    is_lit = out_kind == KIND_LIT
    out_lens = np.where(is_lit, lens, 0)
    dst0 = np.concatenate(([0], np.cumsum(out_lens)))[:-1]
    out_lits = np.full(int(out_lens.sum()), ALL_ONES, WORD_DTYPE)
    for rl, idx, k in zip(rls, idxs, kinds):
        msk = is_lit & (k == KIND_LIT)  # clean-one operands are identity
        if not msk.any():
            continue
        off = rl.lit_starts[idx[msk]] + (left[msk] - rl.bounds[idx[msk]])
        src = rl.lits[_ranges(off, lens[msk])]
        dst = _ranges(dst0[msk], lens[msk])
        out_lits[dst] &= src
    items_per = np.where(is_lit, lens, 1)
    item_kind = np.repeat(out_kind, items_per)
    item_count = np.where(item_kind == KIND_LIT, 1, np.repeat(lens, items_per))
    item_word = np.zeros(len(item_kind), WORD_DTYPE)
    item_word[item_kind == KIND_LIT] = out_lits
    return _groups_to_runlist(item_kind, item_count, item_word)


def _rl_emit(rl: RunList) -> np.ndarray:
    """Canonical RunList -> EWAH word stream, fully vectorized.

    Mirrors ``_emit`` exactly: segments are (clean run, literal stretch)
    pairs; runs longer than MAX_CLEAN spill into extra run-only markers, and
    literal stretches longer than MAX_LIT continue under zero-run markers.
    """
    n_groups = len(rl.kinds)
    if n_groups == 0:
        return np.array([make_marker(0, 0, 0)], WORD_DTYPE)
    gkind = rl.kinds
    gcount = np.diff(rl.bounds)
    is_lit_g = gkind == KIND_LIT
    seg_start = ~is_lit_g
    seg_start[0] = True  # a leading literal stretch opens a run-less segment
    seg_of_group = np.cumsum(seg_start) - 1
    n_seg = int(seg_of_group[-1]) + 1
    run_bit = np.zeros(n_seg, np.int64)
    run_cnt = np.zeros(n_seg, np.int64)
    nlit = np.zeros(n_seg, np.int64)
    starts = np.flatnonzero(seg_start)
    sk = gkind[starts]
    clean_seg = sk != KIND_LIT
    run_bit[clean_seg] = sk[clean_seg]
    run_cnt[clean_seg] = gcount[starts][clean_seg]
    # each segment holds at most one literal group (adjacent ones merged)
    nlit[seg_of_group[is_lit_g]] = gcount[is_lit_g]

    q = np.maximum(1, -(-run_cnt // MAX_CLEAN))   # run markers per segment
    nchunk = np.maximum(1, -(-nlit // MAX_LIT))   # literal chunks per segment
    m = q + nchunk - 1                            # total markers per segment
    rem_run = run_cnt - (q - 1) * MAX_CLEAN
    rem_lit = nlit - (nchunk - 1) * MAX_LIT
    total_m = int(m.sum())
    seg_of = np.repeat(np.arange(n_seg), m)
    mcum0 = np.concatenate(([0], np.cumsum(m)[:-1]))
    j = np.arange(total_m) - np.repeat(mcum0, m)  # marker index within segment
    qs = q[seg_of]
    ms = m[seg_of]
    clean_part = np.where(j < qs - 1, MAX_CLEAN,
                          np.where(j == qs - 1, rem_run[seg_of], 0))
    lit_part = np.where(j < qs - 1, 0,
                        np.where(j == ms - 1, rem_lit[seg_of], MAX_LIT))
    bit_part = np.where(j <= qs - 1, run_bit[seg_of], 0)
    markers = (bit_part | (clean_part << _CLEAN_SHIFT)
               | (lit_part << _LIT_SHIFT)).astype(WORD_DTYPE)

    total = total_m + len(rl.lits)
    out = np.empty(total, WORD_DTYPE)
    mpos = np.concatenate(([0], np.cumsum(1 + lit_part)[:-1])).astype(np.int64)
    is_marker = np.zeros(total, bool)
    is_marker[mpos] = True
    out[is_marker] = markers
    out[~is_marker] = rl.lits
    return out


def _rl_wrap(rl: RunList, n_bits: int) -> EWAH:
    out = EWAH(_rl_emit(rl), n_bits)
    out._rl = rl
    return out


def _empty_ewah(n_bits: int) -> EWAH:
    """The canonical zero-word bitmap: a single (0, 0, 0) marker."""
    return EWAH(np.array([make_marker(0, 0, 0)], WORD_DTYPE), n_bits)


def vec_binary_op(a: EWAH, b: EWAH, op: str) -> EWAH:
    """Vectorized logical op — bit-identical to ``binary_op`` (the oracle).

    When either operand is container-backed the op dispatches per chunk
    on the container-type pair (the other operand is promoted once,
    memoized); all-plain operands take the run-list path unchanged.
    """
    assert a.n_bits == b.n_bits, (a.n_bits, b.n_bits)
    if a.n_words_uncompressed == 0:
        return _empty_ewah(a.n_bits)
    if a._cont is not None or b._cont is not None:
        from .containers import binary_containers
        cont = binary_containers(a.to_containers(force=True)._cont,
                                 b.to_containers(force=True)._cont, op)
        return EWAH._from_containers(cont, a.n_bits)
    return _rl_wrap(_rl_binary(a.runlist(), b.runlist(), op), a.n_bits)


def _rl_is_zero(rl: RunList) -> bool:
    return rl.n_intervals == 1 and rl.kinds[0] == KIND_CLEAN0


def _rl_is_ones(rl: RunList) -> bool:
    return rl.n_intervals == 1 and rl.kinds[0] == KIND_CLEAN1


def or_many(bitmaps: Sequence[EWAH]) -> EWAH:
    """OR-reduce many bitmaps (tree order keeps intermediate results small).

    Folds at the run-list level: operands decode once (memoized) and only
    the final result is re-encoded to EWAH words.  Short-circuits when an
    intermediate union saturates to all-ones.
    """
    assert bitmaps
    bitmaps = list(bitmaps)
    if len(bitmaps) == 1:
        return bitmaps[0]
    n_bits = bitmaps[0].n_bits
    assert all(bm.n_bits == n_bits for bm in bitmaps), \
        [bm.n_bits for bm in bitmaps]
    if bitmaps[0].n_words_uncompressed == 0:
        return _empty_ewah(n_bits)
    if any(bm._cont is not None for bm in bitmaps):
        from .containers import or_many_containers
        cont = or_many_containers(
            [bm.to_containers(force=True)._cont for bm in bitmaps])
        return EWAH._from_containers(cont, n_bits)
    items = [bm.runlist() for bm in bitmaps]
    while len(items) > 1:
        nxt = []
        for i in range(0, len(items) - 1, 2):
            rl = _rl_binary(items[i], items[i + 1], "or")
            if _rl_is_ones(rl):
                return _rl_wrap(rl, n_bits)
            nxt.append(rl)
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return _rl_wrap(items[0], n_bits)


def and_many(bitmaps: Sequence[EWAH]) -> EWAH:
    """AND-reduce many bitmaps in one k-way pass (cheapest-first callers win).

    All operands' run-lists are intersected simultaneously by
    ``_rl_and_many`` — one bounds merge, one classification, one
    canonicalization — instead of folding pairwise (which re-aligns and
    re-canonicalizes at every step).  All-zero operands short-circuit
    immediately and all-one operands drop out before the pass.
    """
    assert bitmaps
    bitmaps = list(bitmaps)
    if len(bitmaps) == 1:
        return bitmaps[0]
    n_bits = bitmaps[0].n_bits
    assert all(bm.n_bits == n_bits for bm in bitmaps), \
        [bm.n_bits for bm in bitmaps]
    if bitmaps[0].n_words_uncompressed == 0:
        return _empty_ewah(n_bits)
    if any(bm._cont is not None for bm in bitmaps):
        from .containers import and_many_containers
        cont = and_many_containers(
            [bm.to_containers(force=True)._cont for bm in bitmaps])
        return EWAH._from_containers(cont, n_bits)
    live: List[EWAH] = []
    for bm in bitmaps:
        rl = bm.runlist()
        if _rl_is_zero(rl):
            return _rl_wrap(rl, n_bits)  # intersection is empty
        if not _rl_is_ones(rl):
            live.append(bm)
    if not live:          # every operand was all-ones
        return bitmaps[0]
    if len(live) == 1:
        return live[0]
    return _rl_wrap(_rl_and_many([bm.runlist() for bm in live]), n_bits)
