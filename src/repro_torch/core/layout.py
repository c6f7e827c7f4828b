"""Self-tuning physical layout: streaming column statistics → sort order
and frequency remaps (paper §4.3 + the histogram-aware line of work).

The paper's Table 6/7 result — column order can halve the index — and the
companion results on value reordering ("Sorting improves word-aligned bitmap
indexes", arXiv:0901.3751; "Histogram-Aware Sorting for Enhanced Word-Aligned
Compression", arXiv:0808.2083) are decisions about the *physical* layout of
the fact table: which column leads the lexicographic sort, and which value
rank each attribute value occupies inside its column's k-of-N code space.
Both are chosen here, from statistics a single streaming pass can collect:

* ``LayoutStats`` — observes row chunks as they flow past (the
  ``Dataset.from_chunks`` ingest loop, a reconstruction sweep in
  ``Dataset.optimize``) and tracks, per column, the running cardinality
  bound (max rank + 1), the row count, and a bounded space-saving-style
  value histogram.  Nothing is ever materialized: memory is
  O(columns x histogram_capacity) regardless of table size.
* ``advise_order(n_rows, cards)`` — the §4.3 frequency-aware rule as a pure
  function of the streaming statistics.  ``sorting.order_columns_freq_aware``
  delegates here, so the streaming path provably picks the *same* order as
  the materialized ``from_rows`` path.
* ``remap_from_counts`` — the histogram-aware value permutation: frequent
  values get adjacent low ranks, so (a) the lexicographic sort clusters the
  hot values' rows and (b) under the alphabetic k-of-N allocation their
  codes share bitmap prefixes — hot runs merge instead of scattering across
  the code space.  Applied at encode time by ``ColumnEncoder(remap=...)``
  and inverted structurally (queries lower values through the encoder, so
  results are always in original ranks).
* ``LayoutDecision`` — the frozen (order, remaps, stats snapshot, advisor
  version) record.  Frozen *before* the external-merge sort starts, carried
  in the store manifest ``meta`` so ``explain()`` and ``/stats`` can say why
  the data is laid out the way it is — and ``Dataset.optimize()`` can
  revisit it later.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

ADVISOR_VERSION = 1

# per-column bounded histogram size: exact counts whenever a column's
# cardinality fits (every dataset in the paper does); beyond it the smallest
# counters are evicted space-saving style and the histogram turns approximate
DEFAULT_HISTOGRAM_CAPACITY = 4096

WORD_BITS = 32


def advise_order(n_rows: int, cards: Sequence[int],
                 word_bits: int = WORD_BITS) -> List[int]:
    """§4.3 frequency-aware column order from (row count, cardinalities).

    Columns whose mean value frequency ``n/card`` is at least one word
    lead, highest cardinality first (their leading runs are word-long);
    columns too fine-grained to repeat a full word trail, lowest
    cardinality first.  Depends only on ``n_rows`` and ``cards`` — both
    O(1)-trackable by a streaming pass — which is what lets
    ``Dataset.from_chunks`` decide the order without materializing rows.
    """
    cards = [int(c) for c in cards]
    n = int(n_rows)
    mean_freq = [n / max(c, 1) for c in cards]
    eligible = [c for c in range(len(cards)) if mean_freq[c] >= word_bits]
    rest = [c for c in range(len(cards)) if mean_freq[c] < word_bits]
    return sorted(eligible, key=lambda c: -cards[c]) + \
        sorted(rest, key=lambda c: cards[c])


def remap_from_counts(card: int, counts: Dict[int, int]) -> Optional[np.ndarray]:
    """Histogram-aware rank permutation: ``remap[original_rank] = new_rank``.

    Observed values order by descending frequency (ties by original rank,
    so the permutation is deterministic); unobserved ranks follow in
    original order.  Returns ``None`` when the permutation is the identity
    — callers then skip the remap entirely and the store header stays
    byte-compatible with remap-free builds.
    """
    card = int(card)
    if not isinstance(counts, dict):  # accept a dense bincount-style array
        arr = np.asarray(counts)
        counts = {int(v): int(k) for v, k in enumerate(arr) if k > 0}
    seen = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    ranked = [v for v, _ in seen if 0 <= v < card]
    present = set(ranked)
    ranked += [v for v in range(card) if v not in present]
    remap = np.empty(card, dtype=np.int64)
    remap[np.asarray(ranked, dtype=np.int64)] = np.arange(card,
                                                          dtype=np.int64)
    if np.array_equal(remap, np.arange(card, dtype=np.int64)):
        return None
    return remap


def validate_remap(remap, card: int) -> Optional[np.ndarray]:
    """Check a user/file-supplied remap is a permutation of ``range(card)``;
    normalize to int64 (identity collapses to ``None``)."""
    if remap is None:
        return None
    r = np.asarray(remap, dtype=np.int64)
    if r.shape != (int(card),):
        raise ValueError(
            f"remap has shape {r.shape}, expected ({card},)")
    if not np.array_equal(np.sort(r), np.arange(card, dtype=np.int64)):
        raise ValueError(f"remap is not a permutation of range({card})")
    if np.array_equal(r, np.arange(card, dtype=np.int64)):
        return None
    return r


@dataclass
class LayoutDecision:
    """A frozen physical-layout choice: what the advisor decided and why.

    ``order`` is the sort column order (``None`` = keep arrival order);
    ``remaps`` holds one optional per-column rank permutation; ``stats`` is
    the advisor's input snapshot (rows, cards, skew) for provenance.  The
    whole record serializes into the store manifest ``meta`` (``to_meta``)
    and back (``from_meta``) so a reopened dataset knows its own layout.
    """

    order: Optional[List[int]] = None
    remaps: Optional[List[Optional[np.ndarray]]] = None
    cards: Optional[List[int]] = None
    n_rows: int = 0
    stats: Dict = field(default_factory=dict)
    advisor_version: int = ADVISOR_VERSION

    @property
    def remapped_columns(self) -> List[int]:
        if not self.remaps:
            return []
        return [c for c, r in enumerate(self.remaps) if r is not None]

    def to_meta(self) -> Dict:
        return {
            "order": list(self.order) if self.order is not None else None,
            "remaps": [r.tolist() if r is not None else None
                       for r in self.remaps] if self.remaps else None,
            "cards": list(self.cards) if self.cards is not None else None,
            "n_rows": int(self.n_rows),
            "stats": self.stats,
            "advisor_version": int(self.advisor_version),
        }

    @classmethod
    def from_meta(cls, meta: Optional[Dict]) -> Optional["LayoutDecision"]:
        if not meta:
            return None
        remaps = meta.get("remaps")
        if remaps is not None:
            remaps = [np.asarray(r, dtype=np.int64) if r is not None else None
                      for r in remaps]
        return cls(order=meta.get("order"), remaps=remaps,
                   cards=meta.get("cards"),
                   n_rows=int(meta.get("n_rows", 0)),
                   stats=meta.get("stats") or {},
                   advisor_version=int(meta.get("advisor_version", 0)))

    def describe(self) -> str:
        """One-line human summary (``Dataset.explain`` header)."""
        order = "arrival" if self.order is None else str(list(self.order))
        remapped = self.remapped_columns
        return (f"layout: order={order}, remapped_columns={remapped}, "
                f"advisor=v{self.advisor_version}")


class LayoutStats:
    """Streaming per-column statistics for the layout advisor.

    Feed row chunks through ``observe``; at any point the collector can
    answer ``cards()`` (running max rank + 1 per column), ``order()`` (the
    §4.3 rule over those cards) and ``remaps()`` (histogram-aware rank
    permutations).  The per-column histogram is bounded by ``capacity``
    entries: while a column's distinct-value count fits, counts are exact;
    beyond it the smallest counters are evicted (space-saving style) and
    ``exact[c]`` flips off — the remap then favors the surviving heavy
    hitters, which is precisely what it is for.

    Peak memory is O(n_columns x capacity) — the collector never holds a
    row beyond the chunk the caller passed in, which is what lets
    ``Dataset.from_chunks`` advise the sort while the raw chunks stream to
    the spill file.
    """

    def __init__(self, capacity: int = DEFAULT_HISTOGRAM_CAPACITY):
        self.capacity = max(int(capacity), 1)
        self.n_rows = 0
        self.n_chunks = 0
        self._max: List[int] = []
        self._counts: List[Dict[int, int]] = []
        self._exact: List[bool] = []

    @property
    def n_columns(self) -> int:
        return len(self._max)

    def observe(self, chunk: np.ndarray) -> "LayoutStats":
        """Account one chunk of rows (any length); returns self."""
        chunk = np.atleast_2d(np.asarray(chunk))
        if chunk.ndim != 2:
            raise ValueError(f"chunk must be 2-D, got shape {chunk.shape}")
        if not len(chunk):
            return self
        d = chunk.shape[1]
        if not self._max:
            self._max = [0] * d
            self._counts = [{} for _ in range(d)]
            self._exact = [True] * d
        elif d != self.n_columns:
            raise ValueError(
                f"chunk has {d} columns, collector saw {self.n_columns}")
        self.n_rows += len(chunk)
        self.n_chunks += 1
        for c in range(d):
            col = chunk[:, c]
            lo = int(col.min())
            if lo < 0:
                raise ValueError(f"column {c} has negative rank {lo}")
            self._max[c] = max(self._max[c], int(col.max()))
            vals, cnts = np.unique(col, return_counts=True)
            counts = self._counts[c]
            for v, k in zip(vals.tolist(), cnts.tolist()):
                counts[v] = counts.get(v, 0) + k
            if len(counts) > self.capacity:
                # evict the lightest counters down to capacity; survivors
                # keep their mass, so heavy hitters stay exact enough for
                # rank ordering even on over-capacity columns
                keep = sorted(counts.items(),
                              key=lambda kv: (-kv[1], kv[0]))[:self.capacity]
                self._counts[c] = dict(keep)
                self._exact[c] = False
        return self

    def cards(self) -> List[int]:
        """Running cardinality bound per column (max observed rank + 1)."""
        return [m + 1 for m in self._max]

    def skew(self, c: int) -> float:
        """Top-value share of column ``c`` (1/card = uniform, →1 = spike)."""
        counts = self._counts[c]
        if not counts or not self.n_rows:
            return 0.0
        return max(counts.values()) / self.n_rows

    def order(self, cards: Optional[Sequence[int]] = None,
              word_bits: int = WORD_BITS) -> List[int]:
        """Advised sort column order (see ``advise_order``).  ``cards``
        pins global cardinalities when the stream may not contain every
        value (mirrors the ``cards`` kwarg of the build paths)."""
        return advise_order(self.n_rows, cards or self.cards(), word_bits)

    def remaps(self, cards: Optional[Sequence[int]] = None
               ) -> Optional[List[Optional[np.ndarray]]]:
        """Per-column frequency remaps (``None`` entries = identity);
        returns ``None`` outright when every column is already in
        frequency order."""
        cards = [int(x) for x in (cards or self.cards())]
        out = [remap_from_counts(card, self._counts[c]
                                 if c < len(self._counts) else {})
               for c, card in enumerate(cards)]
        return out if any(r is not None for r in out) else None

    def snapshot(self) -> Dict:
        """JSON-able provenance blob for the manifest meta / ``/stats``."""
        return {
            "n_rows": int(self.n_rows),
            "n_chunks": int(self.n_chunks),
            "cards": self.cards(),
            "skew": [round(self.skew(c), 6) for c in range(self.n_columns)],
            "distinct_seen": [len(c) for c in self._counts],
            "histogram_exact": list(self._exact),
            "histogram_capacity": self.capacity,
        }

    def decision(self, sort="lex", remap: bool = True,
                 cards: Optional[Sequence[int]] = None) -> LayoutDecision:
        """Freeze the advisor's choice for this stream.

        ``sort`` is ``"lex"`` (advised order), ``"none"`` (no sort) or an
        explicit column order; ``remap`` toggles the per-column frequency
        permutations.  Called once, *before* the external-merge sort
        starts — the sorter and the index builder both consume the frozen
        record, never the live collector.
        """
        cards = [int(x) for x in (cards or self.cards())]
        if isinstance(sort, str):
            if sort == "lex":
                order: Optional[List[int]] = self.order(cards)
            elif sort == "none":
                order = None
            else:
                raise ValueError(
                    f"sort must be 'lex', 'none' or a column order, "
                    f"got {sort!r}")
        else:
            order = [int(c) for c in sort]
            if sorted(order) != list(range(len(cards))):
                raise ValueError(
                    f"explicit sort order {order} is not a permutation of "
                    f"range({len(cards)})")
        return LayoutDecision(order=order,
                              remaps=self.remaps(cards) if remap else None,
                              cards=cards, n_rows=self.n_rows,
                              stats=self.snapshot())
