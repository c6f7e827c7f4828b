"""Roaring-style hybrid containers behind the EWAH interface.

Each bitmap is partitioned into fixed-width chunks of 2^16 bits (2048
32-bit words, word-aligned), and every chunk is stored as whichever
container the cost model picks for its content:

  * ``T_ARRAY`` — sorted ``uint16`` chunk-local bit positions.  Wins on
    sparse chunks (shuffled / adversarial column distributions where
    word-aligned RLE degenerates to one marker + one literal word per
    set bit: 2 bytes/bit vs 8+).
  * ``T_DENSE`` — the chunk's uncompressed ``uint32`` words, verbatim.
    Mid-density chunks; feeds the bucketed Pallas kernels in
    ``kernels/ops.py`` without an unpack step.
  * ``T_RUN``   — the current word-aligned run-list form, chunk-local
    (``RunList`` in memory, canonical EWAH words at rest).  Wins on
    sorted tables, where the paper's RLE analysis applies.
  * ``T_EMPTY`` / ``T_FULL`` — directory-only: no payload, short-circuit
    at dispatch time without touching any words.

All logical ops dispatch per-chunk on the container-type pair; results
are re-normalized (array↔dense↔empty/full) so chains of ops keep the
cheap representation.  Conversion back to the canonical run-list
(``containers_to_runlist``) funnels every chunk through the same
``_groups_to_runlist`` canonicalization the word codec uses, so a
container-backed bitmap emits EWAH words *bit-identical* to the pure
run-list pipeline — the property the oracle suite in
``tests/test_containers.py`` enforces.
"""
from __future__ import annotations

import numpy as np
from typing import List, Optional, Sequence

from .ewah import (
    ALL_ONES,
    KIND_CLEAN0,
    KIND_CLEAN1,
    KIND_LIT,
    RunList,
    WORD_DTYPE,
    _decode_runlist,
    _groups_to_runlist,
    _popcount_words,
    _ranges,
    _rl_and_many,
    _rl_binary,
    _rl_emit,
    _rl_is_ones,
    _rl_is_zero,
    _rl_to_words,
)

CHUNK_BITS = 1 << 16
CHUNK_WORDS = CHUNK_BITS // 32  # 2048

# container types (persisted in the store directory — do not renumber)
T_EMPTY = 0
T_FULL = 1
T_ARRAY = 2
T_DENSE = 3
T_RUN = 4

DEFAULT_ARRAY_CUTOFF = 4096  # positions; above this a dense chunk is smaller

_TYPE_NAMES = {T_EMPTY: "empty", T_FULL: "full", T_ARRAY: "array",
               T_DENSE: "dense", T_RUN: "run"}


def resolve_cutoff(model=None) -> int:
    """Array-container crossover from the calibrated cost model."""
    if model is None:
        from .cost_model import get_default
        model = get_default()
    return int(getattr(model, "array_cutoff", DEFAULT_ARRAY_CUTOFF))


def _n_chunks(n_words: int) -> int:
    return -(-n_words // CHUNK_WORDS) if n_words else 0


def _chunk_nw(n_words: int, i: int) -> int:
    return min(CHUNK_WORDS, n_words - i * CHUNK_WORDS)


class Containers:
    """Chunk directory + per-chunk payloads for one bitmap.

    ``types``/``counts`` are the directory (O(1) popcount, empty/full
    short-circuits without touching payloads); ``payloads[i]`` is
    ``None`` (empty/full), a sorted ``uint16`` position array, a
    ``uint32`` word array, or a chunk-local ``RunList``.  Run payloads
    loaded from a store arrive as canonical EWAH word views and are
    decoded lazily on first access (``run_rl``).  Treat all payloads as
    read-only — array/dense views may be zero-copy windows into a
    memory-mapped store segment.
    """

    __slots__ = ("n_bits", "n_words", "types", "counts", "payloads")

    def __init__(self, n_bits: int, types: np.ndarray, counts: np.ndarray,
                 payloads: List):
        self.n_bits = int(n_bits)
        self.n_words = -(-self.n_bits // 32)
        self.types = np.asarray(types, dtype=np.uint8)
        self.counts = np.asarray(counts, dtype=np.int64)
        self.payloads = payloads

    @property
    def n_chunks(self) -> int:
        return len(self.types)

    def chunk_nw(self, i: int) -> int:
        return _chunk_nw(self.n_words, i)

    def count(self) -> int:
        return int(self.counts.sum())

    def run_rl(self, i: int) -> RunList:
        """Chunk ``i``'s run payload as a RunList (lazy store decode)."""
        p = self.payloads[i]
        if not isinstance(p, RunList):
            p = _decode_runlist(np.ascontiguousarray(p, dtype=WORD_DTYPE))
            self.payloads[i] = p
        return p

    def chunk(self, i: int):
        """(type, count, payload) with run payloads decoded."""
        t = int(self.types[i])
        if t == T_RUN:
            return t, int(self.counts[i]), self.run_rl(i)
        return t, int(self.counts[i]), self.payloads[i]

    # -- size accounting ---------------------------------------------------
    @property
    def size_words(self) -> int:
        """Exact serialized size in 32-bit words (directory + payloads)."""
        total = 1 + 3 * self.n_chunks
        for i in range(self.n_chunks):
            total += self._payload_words(i)
        return total

    def _payload_words(self, i: int) -> int:
        t = int(self.types[i])
        if t == T_ARRAY:
            return (int(self.counts[i]) + 1) // 2
        if t == T_DENSE:
            return len(self.payloads[i])
        if t == T_RUN:
            p = self.payloads[i]
            return _run_words_exact(p) if isinstance(p, RunList) else len(p)
        return 0

    def type_summary(self) -> str:
        """Dominant container type — cache/stats classification label."""
        present = set(int(t) for t in np.unique(self.types)) - {T_EMPTY, T_FULL}
        if not present:
            return "empty" if not (self.types == T_FULL).any() else "full"
        if len(present) == 1:
            return _TYPE_NAMES[present.pop()]
        return "mixed"

    # -- store blob --------------------------------------------------------
    def serialize(self) -> np.ndarray:
        """Flat uint32 blob: [n_chunks][type,payload_words,count]*n[payloads].

        Array payloads are packed two ``uint16`` positions per word
        (zero-padded to a word boundary); dense payloads are words
        verbatim; run payloads are canonical chunk-local EWAH words —
        all 4-byte aligned so the loader can hand back zero-copy views.
        """
        n = self.n_chunks
        directory = np.zeros((n, 3), dtype=WORD_DTYPE)
        parts: List[np.ndarray] = []
        for i in range(n):
            t = int(self.types[i])
            if t == T_ARRAY:
                a = np.ascontiguousarray(self.payloads[i], dtype=np.uint16)
                if len(a) % 2:
                    a = np.concatenate((a, np.zeros(1, np.uint16)))
                w = a.view(WORD_DTYPE)
            elif t == T_DENSE:
                w = np.ascontiguousarray(self.payloads[i], dtype=WORD_DTYPE)
            elif t == T_RUN:
                p = self.payloads[i]
                w = _rl_emit(p) if isinstance(p, RunList) \
                    else np.ascontiguousarray(p, dtype=WORD_DTYPE)
            else:
                w = np.empty(0, WORD_DTYPE)
            directory[i] = (t, len(w), int(self.counts[i]))
            if len(w):
                parts.append(w)
        head = np.concatenate((np.array([n], WORD_DTYPE), directory.ravel()))
        return np.concatenate([head] + parts) if parts else head

    @classmethod
    def deserialize(cls, words: np.ndarray, n_bits: int) -> "Containers":
        """Parse a blob; array/dense payloads stay zero-copy views."""
        n = int(words[0])
        directory = np.asarray(words[1:1 + 3 * n],
                               dtype=np.int64).reshape(n, 3)
        types = directory[:, 0].astype(np.uint8)
        pw = directory[:, 1]
        counts = directory[:, 2].astype(np.int64)
        offs = 1 + 3 * n + np.concatenate(([0], np.cumsum(pw)))
        payloads: List = []
        for i in range(n):
            t, o, e = int(types[i]), int(offs[i]), int(offs[i] + pw[i])
            if t == T_ARRAY:
                payloads.append(words[o:e].view(np.uint16)[:int(counts[i])])
            elif t in (T_DENSE, T_RUN):
                payloads.append(words[o:e])
            else:
                payloads.append(None)
        return cls(n_bits, types, counts, payloads)


# ---------------------------------------------------------------------------
# Chunk-level primitives.
# ---------------------------------------------------------------------------

def _rl_count(rl: RunList) -> int:
    lens = np.diff(rl.bounds)
    return (32 * int(lens[rl.kinds == KIND_CLEAN1].sum())
            + _popcount_words(rl.lits))


def _run_words_exact(rl: RunList) -> int:
    """Serialized EWAH word count of a chunk-local run-list.

    Chunks hold ≤ 2048 words, far under MAX_CLEAN/MAX_LIT, so every
    (clean run, literal stretch) segment is exactly one marker.
    """
    if rl.n_intervals == 0:
        return 1
    n_clean = int((rl.kinds != KIND_LIT).sum())
    lead_lit = 1 if rl.kinds[0] == KIND_LIT else 0
    return max(1, n_clean + lead_lit) + len(rl.lits)


def _rl_slice(rl: RunList, w0: int, w1: int) -> RunList:
    """Words ``[w0, w1)`` of a run-list as a chunk-local RunList.

    Pure interval clip (no bit shifting): canonical invariants survive
    slicing, so the result maps straight onto canonical chunk words.
    """
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
    lit_starts = np.zeros(len(kinds), np.int64)
    lit_starts[lit_mask] = np.concatenate(
        ([0], np.cumsum(lens[lit_mask])))[:-1]
    return RunList(bounds - w0, kinds, lit_starts, lits)


def _scatter(pos: np.ndarray, nw: int) -> np.ndarray:
    """Chunk-local positions -> chunk words."""
    out = np.zeros(nw, WORD_DTYPE)
    p = pos.astype(np.int64)
    np.bitwise_or.at(out, p >> 5, np.uint32(1) << (p & 31).astype(np.uint32))
    return out


def _words_to_positions(words: np.ndarray) -> np.ndarray:
    nz = np.flatnonzero(words)
    if nz.size == 0:
        return np.empty(0, np.uint16)
    bits = ((words[nz, None] >> np.arange(32, dtype=np.uint32)) & 1) \
        .astype(bool)
    offs = (nz[:, None] << 5) + np.arange(32)
    return offs[bits].astype(np.uint16)


def _in_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Membership mask of sorted-unique ``a`` in sorted-unique ``b``."""
    out = np.zeros(len(a), bool)
    if len(b) == 0:
        return out
    i = np.searchsorted(b, a)
    valid = i < len(b)
    out[valid] = b[i[valid]] == a[valid]
    return out


def _membership(pos: np.ndarray, t: int, p) -> np.ndarray:
    """Mask: which of the sorted chunk-local positions are set in (t, p)."""
    if t == T_EMPTY:
        return np.zeros(len(pos), bool)
    if t == T_FULL:
        return np.ones(len(pos), bool)
    if t == T_ARRAY:
        return _in_sorted(pos, p)
    p64 = pos.astype(np.int64)
    shift = (p64 & 31).astype(np.uint32)
    if t == T_DENSE:
        return ((p[p64 >> 5] >> shift) & 1).astype(bool)
    # T_RUN: interval lookup, literal words bit-tested individually
    wi = p64 >> 5
    ii = np.searchsorted(p.bounds, wi, side="right") - 1
    k = p.kinds[ii]
    keep = k == KIND_CLEAN1
    lm = k == KIND_LIT
    if lm.any():
        w = p.lits[p.lit_starts[ii[lm]] + (wi[lm] - p.bounds[ii[lm]])]
        keep[lm] = ((w >> shift[lm]) & 1).astype(bool)
    return keep


def _to_chunk_words(t: int, p, nw: int) -> np.ndarray:
    """Materialize a chunk to dense words.  DENSE returns the payload
    itself — callers that mutate must copy."""
    if t == T_EMPTY:
        return np.zeros(nw, WORD_DTYPE)
    if t == T_FULL:
        return np.full(nw, ALL_ONES, WORD_DTYPE)
    if t == T_DENSE:
        return p
    if t == T_ARRAY:
        return _scatter(p, nw)
    return _rl_to_words(p)


def _norm_words(words: np.ndarray, cutoff: int):
    """Classify freshly computed chunk words into the cheapest container."""
    cnt = _popcount_words(words)
    if cnt == 0:
        return T_EMPTY, 0, None
    if cnt == 32 * len(words):
        return T_FULL, cnt, None
    if cnt <= cutoff:
        return T_ARRAY, cnt, _words_to_positions(words)
    return T_DENSE, cnt, words


def _norm_array(pos: np.ndarray, nw: int, cutoff: int):
    cnt = len(pos)
    if cnt == 0:
        return T_EMPTY, 0, None
    if cnt <= cutoff:
        return T_ARRAY, cnt, np.ascontiguousarray(pos, dtype=np.uint16)
    words = _scatter(pos, nw)
    if cnt == 32 * nw:
        return T_FULL, cnt, None
    return T_DENSE, cnt, words


def _norm_rl(rl: RunList):
    if _rl_is_zero(rl):
        return T_EMPTY, 0, None
    if _rl_is_ones(rl):
        return T_FULL, 32 * rl.n_words, None
    return T_RUN, _rl_count(rl), rl


def _array_result(pos: np.ndarray):
    if pos.size == 0:
        return T_EMPTY, 0, None
    return T_ARRAY, len(pos), np.ascontiguousarray(pos, dtype=np.uint16)


# ---------------------------------------------------------------------------
# Per-chunk binary dispatch.
# ---------------------------------------------------------------------------

def _op_chunk(op: str, A, B, nw: int, cutoff: int):
    ta, ca, pa = A
    tb, cb, pb = B
    if op == "and":
        if ta == T_EMPTY or tb == T_EMPTY:
            return T_EMPTY, 0, None
        if ta == T_FULL:
            return tb, cb, pb
        if tb == T_FULL:
            return ta, ca, pa
        if ta == T_ARRAY or tb == T_ARRAY:
            if ta == T_ARRAY and (tb != T_ARRAY or ca <= cb):
                pos, ot, op_ = pa, tb, pb
            else:
                pos, ot, op_ = pb, ta, pa
            return _array_result(pos[_membership(pos, ot, op_)])
        if ta == T_RUN and tb == T_RUN:
            return _norm_rl(_rl_binary(pa, pb, "and"))
        return _norm_words(np.bitwise_and(_to_chunk_words(ta, pa, nw),
                                          _to_chunk_words(tb, pb, nw)),
                           cutoff)
    if op == "or":
        if ta == T_FULL or tb == T_FULL:
            return T_FULL, 32 * nw, None
        if ta == T_EMPTY:
            return tb, cb, pb
        if tb == T_EMPTY:
            return ta, ca, pa
        if ta == T_ARRAY and tb == T_ARRAY:
            return _norm_array(np.union1d(pa, pb), nw, cutoff)
        if ta == T_RUN and tb == T_RUN:
            return _norm_rl(_rl_binary(pa, pb, "or"))
        if ta == T_ARRAY or tb == T_ARRAY:
            pos, ot, op_ = (pa, tb, pb) if ta == T_ARRAY else (pb, ta, pa)
            w = _to_chunk_words(ot, op_, nw)
            w = w.copy() if ot == T_DENSE else w
            p64 = pos.astype(np.int64)
            np.bitwise_or.at(w, p64 >> 5,
                             np.uint32(1) << (p64 & 31).astype(np.uint32))
            return _norm_words(w, cutoff)
        return _norm_words(np.bitwise_or(_to_chunk_words(ta, pa, nw),
                                         _to_chunk_words(tb, pb, nw)),
                           cutoff)
    if op == "xor":
        if ta == T_EMPTY:
            return tb, cb, pb
        if tb == T_EMPTY:
            return ta, ca, pa
        if ta == T_FULL and tb == T_FULL:
            return T_EMPTY, 0, None
        if ta == T_FULL or tb == T_FULL:
            ot, op_ = (tb, pb) if ta == T_FULL else (ta, pa)
            return _norm_words(np.bitwise_not(_to_chunk_words(ot, op_, nw)),
                               cutoff)
        if ta == T_ARRAY and tb == T_ARRAY:
            return _norm_array(np.setxor1d(pa, pb, assume_unique=True),
                               nw, cutoff)
        if ta == T_RUN and tb == T_RUN:
            return _norm_rl(_rl_binary(pa, pb, "xor"))
        if ta == T_ARRAY or tb == T_ARRAY:
            pos, ot, op_ = (pa, tb, pb) if ta == T_ARRAY else (pb, ta, pa)
            w = _to_chunk_words(ot, op_, nw)
            w = w.copy() if ot == T_DENSE else w
            p64 = pos.astype(np.int64)
            np.bitwise_xor.at(w, p64 >> 5,
                              np.uint32(1) << (p64 & 31).astype(np.uint32))
            return _norm_words(w, cutoff)
        return _norm_words(np.bitwise_xor(_to_chunk_words(ta, pa, nw),
                                          _to_chunk_words(tb, pb, nw)),
                           cutoff)
    # andnot: A & ~B
    if ta == T_EMPTY or tb == T_FULL:
        return T_EMPTY, 0, None
    if tb == T_EMPTY:
        return ta, ca, pa
    if ta == T_FULL:
        return _norm_words(np.bitwise_not(_to_chunk_words(tb, pb, nw)),
                           cutoff)
    if ta == T_ARRAY:
        return _array_result(pa[~_membership(pa, tb, pb)])
    if ta == T_RUN and tb == T_RUN:
        return _norm_rl(_rl_binary(pa, pb, "andnot"))
    if tb == T_ARRAY:
        w = _to_chunk_words(ta, pa, nw)
        w = w.copy() if ta == T_DENSE else w
        p64 = pb.astype(np.int64)
        np.bitwise_and.at(
            w, p64 >> 5,
            np.bitwise_not(np.uint32(1) << (p64 & 31).astype(np.uint32)))
        return _norm_words(w, cutoff)
    return _norm_words(
        np.bitwise_and(_to_chunk_words(ta, pa, nw),
                       np.bitwise_not(_to_chunk_words(tb, pb, nw))),
        cutoff)


def binary_containers(ca: Containers, cb: Containers, op: str,
                      cutoff: Optional[int] = None) -> Containers:
    assert ca.n_bits == cb.n_bits, (ca.n_bits, cb.n_bits)
    if cutoff is None:
        cutoff = resolve_cutoff()
    n = ca.n_chunks
    types = np.empty(n, np.uint8)
    counts = np.zeros(n, np.int64)
    payloads: List = [None] * n
    for i in range(n):
        t, c, p = _op_chunk(op, ca.chunk(i), cb.chunk(i), ca.chunk_nw(i),
                            cutoff)
        types[i], counts[i], payloads[i] = t, c, p
    return Containers(ca.n_bits, types, counts, payloads)


# ---------------------------------------------------------------------------
# n-ary dispatch.
# ---------------------------------------------------------------------------

def and_many_containers(conts: Sequence[Containers],
                        cutoff: Optional[int] = None) -> Containers:
    """k-way AND: one pass over the chunk directory; the sparsest array
    operand drives membership filtering so work scales with the smallest
    chunk, not the sum of operands."""
    if cutoff is None:
        cutoff = resolve_cutoff()
    first = conts[0]
    n = first.n_chunks
    types = np.empty(n, np.uint8)
    counts = np.zeros(n, np.int64)
    payloads: List = [None] * n
    # one vectorized directory pass resolves trivial chunks up front
    tmat = np.stack([np.asarray(c.types) for c in conts])
    any_empty = (tmat == T_EMPTY).any(axis=0)
    all_full = (tmat == T_FULL).all(axis=0)
    types[any_empty] = T_EMPTY
    for i in range(n):
        nw = first.chunk_nw(i)
        if any_empty[i]:
            continue
        if all_full[i]:
            types[i], counts[i] = T_FULL, 32 * nw
            continue
        live = [c.chunk(i) for c in conts if c.types[i] != T_FULL]
        if len(live) == 1:
            types[i], counts[i], payloads[i] = live[0]
            continue
        arr_js = [j for j, ch in enumerate(live) if ch[0] == T_ARRAY]
        if arr_js:
            base = min(arr_js, key=lambda j: live[j][1])
            pos = live[base][2]
            for j, (t, _, p) in enumerate(live):
                if j == base or pos.size == 0:
                    continue
                pos = pos[_membership(pos, t, p)]
            types[i], counts[i], payloads[i] = _array_result(pos)
        elif all(ch[0] == T_RUN for ch in live):
            types[i], counts[i], payloads[i] = _norm_rl(
                _rl_and_many([ch[2] for ch in live]))
        else:
            acc = _to_chunk_words(live[0][0], live[0][2], nw)
            for t, _, p in live[1:]:
                acc = np.bitwise_and(acc, _to_chunk_words(t, p, nw))
            types[i], counts[i], payloads[i] = _norm_words(acc, cutoff)
    return Containers(first.n_bits, types, counts, payloads)


def or_many_containers(conts: Sequence[Containers],
                       cutoff: Optional[int] = None) -> Containers:
    """k-way OR: full chunks short-circuit from the directory; all-array
    chunks union positions in one concatenate+unique pass."""
    if cutoff is None:
        cutoff = resolve_cutoff()
    first = conts[0]
    n = first.n_chunks
    types = np.empty(n, np.uint8)
    counts = np.zeros(n, np.int64)
    payloads: List = [None] * n
    tmat = np.stack([np.asarray(c.types) for c in conts])
    any_full = (tmat == T_FULL).any(axis=0)
    all_empty = (tmat == T_EMPTY).all(axis=0)
    types[all_empty] = T_EMPTY
    for i in range(n):
        nw = first.chunk_nw(i)
        if all_empty[i]:
            continue
        if any_full[i]:
            types[i], counts[i] = T_FULL, 32 * nw
            continue
        live = [c.chunk(i) for c in conts if c.types[i] != T_EMPTY]
        if len(live) == 1:
            types[i], counts[i], payloads[i] = live[0]
            continue
        if all(ch[0] == T_ARRAY for ch in live):
            pos = np.unique(np.concatenate([ch[2] for ch in live]))
            types[i], counts[i], payloads[i] = _norm_array(pos, nw, cutoff)
        elif all(ch[0] == T_RUN for ch in live):
            rl = live[0][2]
            for ch in live[1:]:
                rl = _rl_binary(rl, ch[2], "or")
                if _rl_is_ones(rl):
                    break
            types[i], counts[i], payloads[i] = _norm_rl(rl)
        else:
            acc = np.zeros(nw, WORD_DTYPE)
            for t, _, p in live:
                if t == T_ARRAY:
                    p64 = p.astype(np.int64)
                    np.bitwise_or.at(
                        acc, p64 >> 5,
                        np.uint32(1) << (p64 & 31).astype(np.uint32))
                else:
                    acc |= _to_chunk_words(t, p, nw)
            types[i], counts[i], payloads[i] = _norm_words(acc, cutoff)
    return Containers(first.n_bits, types, counts, payloads)


def and_count_containers(ca: Containers, cb: Containers) -> int:
    """Popcount of AND without materializing a result bitmap."""
    total = 0
    for i in range(ca.n_chunks):
        ta = int(ca.types[i])
        tb = int(cb.types[i])
        if ta == T_EMPTY or tb == T_EMPTY:
            continue
        if ta == T_FULL:
            total += int(cb.counts[i])
            continue
        if tb == T_FULL:
            total += int(ca.counts[i])
            continue
        A, B = ca.chunk(i), cb.chunk(i)
        if ta == T_ARRAY or tb == T_ARRAY:
            if ta == T_ARRAY and (tb != T_ARRAY or A[1] <= B[1]):
                pos, ot, op_ = A[2], tb, B[2]
            else:
                pos, ot, op_ = B[2], ta, A[2]
            total += int(_membership(pos, ot, op_).sum())
        elif ta == T_RUN and tb == T_RUN:
            total += _rl_count(_rl_binary(A[2], B[2], "and"))
        else:
            nw = ca.chunk_nw(i)
            total += _popcount_words(
                np.bitwise_and(_to_chunk_words(ta, A[2], nw),
                               _to_chunk_words(tb, B[2], nw)))
    return total


# ---------------------------------------------------------------------------
# Conversions to/from the canonical run-list world.
# ---------------------------------------------------------------------------

def containers_to_runlist(cont: Containers) -> RunList:
    """Canonical whole-bitmap RunList — the bridge back to EWAH words.

    Every chunk contributes (kind, count, word) items; one
    ``_groups_to_runlist`` pass merges across chunk boundaries and
    reclassifies secretly-clean literal words, so the emitted marker
    stream is bit-identical to the pure run-list pipeline's.
    """
    kinds: List[np.ndarray] = []
    cnts: List[np.ndarray] = []
    words: List[np.ndarray] = []
    for i in range(cont.n_chunks):
        nw = cont.chunk_nw(i)
        t, _, p = cont.chunk(i)
        if t == T_EMPTY or t == T_FULL:
            kinds.append(np.array(
                [KIND_CLEAN1 if t == T_FULL else KIND_CLEAN0], np.int8))
            cnts.append(np.array([nw], np.int64))
            words.append(np.zeros(1, WORD_DTYPE))
        elif t == T_RUN:
            rl = p
            lens = np.diff(rl.bounds)
            is_lit = rl.kinds == KIND_LIT
            per = np.where(is_lit, lens, 1)
            ik = np.repeat(rl.kinds, per)
            ic = np.where(ik == KIND_LIT, 1, np.repeat(lens, per))
            iw = np.zeros(len(ik), WORD_DTYPE)
            iw[ik == KIND_LIT] = rl.lits
            kinds.append(ik)
            cnts.append(ic)
            words.append(iw)
        else:
            w = _to_chunk_words(t, p, nw)
            kinds.append(np.full(nw, KIND_LIT, np.int8))
            cnts.append(np.ones(nw, np.int64))
            words.append(np.asarray(w, WORD_DTYPE))
    return _groups_to_runlist(np.concatenate(kinds), np.concatenate(cnts),
                              np.concatenate(words))


def containers_to_dense(cont: Containers) -> np.ndarray:
    """All uncompressed words — the kernel feed (dense chunks copy-free
    until the final concatenate)."""
    if cont.n_chunks == 0:
        return np.empty(0, WORD_DTYPE)
    parts = []
    for i in range(cont.n_chunks):
        t, _, p = cont.chunk(i)
        parts.append(_to_chunk_words(t, p, cont.chunk_nw(i)))
    return np.concatenate(parts)


def runlist_to_containers(rl: RunList, n_bits: int,
                          cutoff: Optional[int] = None) -> Containers:
    """Chunk a whole-bitmap RunList, choosing each chunk's container by
    exact serialized size (run vs array vs dense words)."""
    if cutoff is None:
        cutoff = resolve_cutoff()
    n_words = -(-int(n_bits) // 32)
    n = _n_chunks(n_words)
    types = np.empty(n, np.uint8)
    counts = np.zeros(n, np.int64)
    payloads: List = [None] * n
    for i in range(n):
        w0 = i * CHUNK_WORDS
        nw = _chunk_nw(n_words, i)
        crl = _rl_slice(rl, w0, w0 + nw)
        if _rl_is_zero(crl):
            types[i], counts[i] = T_EMPTY, 0
            continue
        if _rl_is_ones(crl):
            types[i], counts[i] = T_FULL, 32 * nw
            continue
        cnt = _rl_count(crl)
        run_w = _run_words_exact(crl)
        arr_w = (cnt + 1) // 2
        if run_w <= arr_w and run_w <= nw:
            types[i], counts[i], payloads[i] = T_RUN, cnt, crl
        elif cnt <= cutoff and arr_w < nw:
            types[i], counts[i], payloads[i] = \
                T_ARRAY, cnt, _words_to_positions(_rl_to_words(crl))
        else:
            types[i], counts[i], payloads[i] = T_DENSE, cnt, _rl_to_words(crl)
    return Containers(n_bits, types, counts, payloads)


def containers_from_positions(positions: np.ndarray, n_bits: int,
                              cutoff: Optional[int] = None) -> Containers:
    """Native container build from sorted-unique set-bit positions —
    the delta-append path: sparse chunks become arrays directly, never
    paying the RLE penalty of arrival-order data."""
    if cutoff is None:
        cutoff = resolve_cutoff()
    n_words = -(-int(n_bits) // 32)
    n = _n_chunks(n_words)
    types = np.empty(n, np.uint8)
    counts = np.zeros(n, np.int64)
    payloads: List = [None] * n
    edges = np.searchsorted(positions,
                            np.arange(n + 1, dtype=np.int64) * CHUNK_BITS)
    for i in range(n):
        nw = _chunk_nw(n_words, i)
        lp = positions[edges[i]:edges[i + 1]] - i * CHUNK_BITS
        cnt = len(lp)
        if cnt == 0:
            types[i], counts[i] = T_EMPTY, 0
            continue
        w = _scatter(lp, nw)
        if cnt == 32 * nw:
            types[i], counts[i] = T_FULL, cnt
            continue
        # exact run form size without building it: clean-word groups — the
        # SAME decision ``runlist_to_containers`` makes, so both build
        # paths pick identical types (clustered delta appends collapse to
        # runs instead of sticking as arrays)
        is_clean = (w == 0) | (w == ALL_ONES)
        key = np.where(is_clean, (w == ALL_ONES).astype(np.int8), np.int8(-1))
        gstart = np.concatenate(
            ([0], np.flatnonzero(key[1:] != key[:-1]) + 1))
        gk = key[gstart]
        run_w = (int((gk >= 0).sum()) + (1 if gk[0] < 0 else 0)
                 + int((~is_clean).sum()))
        arr_w = (cnt + 1) // 2
        if run_w <= min(nw, arr_w):
            crl = _groups_to_runlist(np.full(nw, KIND_LIT, np.int8),
                                     np.ones(nw, np.int64), w)
            types[i], counts[i], payloads[i] = T_RUN, cnt, crl
        elif cnt <= cutoff and arr_w < nw:
            types[i], counts[i], payloads[i] = \
                T_ARRAY, cnt, lp.astype(np.uint16)
        else:
            types[i], counts[i], payloads[i] = T_DENSE, cnt, w
    return Containers(n_bits, types, counts, payloads)


def worthwhile(cont: Containers) -> bool:
    """True when at least one chunk chose an array/dense container —
    otherwise the bitmap is pure run material and the plain run-list
    pipeline is strictly better (no per-chunk dispatch overhead)."""
    return bool(np.isin(cont.types, (T_ARRAY, T_DENSE)).any())
