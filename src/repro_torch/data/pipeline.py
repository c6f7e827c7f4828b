"""Fact-table-backed training data pipeline (the paper as a data substrate).

The corpus metadata is a *fact table* — one row per document with columns
(source, lang, length_bucket, quality, dedup_cluster).  The pipeline now
rides on the ``repro_torch.core.Dataset`` façade: one object owns the sort
(external merge, frequency-aware column order, paper §4.3), the streaming
k-of-N EWAH index build, and the statement API.  Sample-selection
predicates ("lang == fr AND quality >= q3") execute as planned bitmap
queries, and ``composition()`` reports the selected corpus's per-value
make-up straight from the compressed domain (group-by counts — no row
materialization), reproducing the paper's aggregate-workload story inside
the training stack.

The pipeline is *seekable*: batch(step) is a pure function of (selected ids,
seed, step), which fault tolerance relies on for exact replay after restart.
Batches are NumPy token arrays; the caller moves them to its device.  The
``device`` is the dataset's: where its queries run the kernel path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import BitmapIndex, random_shuffle
from repro_torch.core.dataset import Dataset
from repro_torch.core.expr import And, Eq, Expr, Not, Or

COLUMNS = ("source", "lang", "length_bucket", "quality", "dedup_cluster")


@dataclass
class Corpus:
    tokens: np.ndarray          # (n_docs, doc_len) int32
    fact_table: np.ndarray      # (n_docs, 5) int64 value ranks
    cards: Tuple[int, ...]

    @classmethod
    def synthetic(cls, n_docs: int = 4096, doc_len: int = 512,
                  vocab: int = 50_000, seed: int = 0) -> "Corpus":
        rng = np.random.default_rng(seed)
        tokens = rng.integers(0, vocab, size=(n_docs, doc_len), dtype=np.int32)
        cards = (12, 30, 8, 5, max(n_docs // 16, 2))
        cols = [rng.integers(0, c, size=n_docs) for c in cards[:4]]
        cols.append(rng.integers(0, cards[4], size=n_docs))  # dedup cluster
        fact = np.stack(cols, axis=1).astype(np.int64)
        return cls(tokens=tokens, fact_table=fact, cards=cards)


class BitmapDataPipeline:
    def __init__(self, corpus: Corpus, sort: bool = True, k: int = 1,
                 seed: int = 0, chunk_rows: int = 4096,
                 device: Union[str, torch.device] = "cuda"):
        self.corpus = corpus
        self.seed = seed
        self.chunk_rows = int(chunk_rows)
        rng = np.random.default_rng(seed)
        # word-aligned partitions bound the builder's buffering to one
        # chunk; corpora up to chunk_rows docs still get one partition
        part = self.chunk_rows - self.chunk_rows % 32 or 32
        if sort:
            # Dataset sorts with the external merge (only chunk_rows rows
            # sorted at once, same permutation — and hence same index — as
            # a full in-memory lex sort) under the §4.3 freq-aware order
            self.ds = Dataset.from_rows(
                corpus.fact_table, columns=COLUMNS, sort="lex", k=k,
                cards=corpus.cards, chunk_rows=self.chunk_rows,
                partition_rows=part, device=device)
            self.row_perm = self.ds.row_perm
            self.col_order = self.ds.sort_order
        else:
            self.row_perm = random_shuffle(corpus.fact_table, rng)
            self.ds = Dataset.from_rows(
                corpus.fact_table[self.row_perm], columns=COLUMNS,
                sort="none", k=k, cards=corpus.cards,
                chunk_rows=self.chunk_rows, partition_rows=part,
                device=device)
            self.col_order = list(range(corpus.fact_table.shape[1]))
        self.table = self.ds.table
        self.index = self.ds.index
        self._filter: Optional[Expr] = None
        self.selected: np.ndarray = np.arange(len(self.table))

    # -- selection ----------------------------------------------------------
    def select(self, conj: Optional[Dict[str, int]] = None,
               disj: Optional[Dict[str, int]] = None,
               exclude: Optional[Dict[str, int]] = None) -> int:
        """Install the sample filter; returns the number of selected docs."""
        col = {name: i for i, name in enumerate(COLUMNS)}
        parts: List[Expr] = []
        if conj:
            parts.extend(Eq(col[c], v) for c, v in sorted(conj.items()))
        if disj:
            parts.append(Or(tuple(Eq(col[c], v)
                                  for c, v in sorted(disj.items()))))
        if exclude:  # the planner fuses this into a compressed-domain andnot
            parts.append(Not(Or(tuple(Eq(col[c], v)
                                      for c, v in sorted(exclude.items())))))
        if not parts:
            self._filter = None
            sel = np.arange(len(self.table))
        else:
            self._filter = parts[0] if len(parts) == 1 else And(tuple(parts))
            sel = self.ds.query().where(self._filter).rows()
        self.selected = sel
        return len(sel)

    def selected_count(self) -> int:
        """Size of the current selection without materializing row ids —
        a compressed-domain COUNT statement."""
        q = self.ds.query()
        if self._filter is not None:
            q = q.where(self._filter)
        return q.count()

    def composition(self, column: str) -> np.ndarray:
        """Per-value document counts of the current selection for one
        metadata column (``np.bincount`` shape), computed by group-by in
        the compressed domain — the corpus-mix report never decompresses a
        bitmap to rows."""
        q = self.ds.query()
        if self._filter is not None:
            q = q.where(self._filter)
        return q.group_by(column).count()

    # -- seekable batches ----------------------------------------------------
    def batch(self, step: int, batch_size: int, seq_len: int) -> Dict[str, np.ndarray]:
        """Pure function of (selection, seed, step) — restart-safe."""
        n = len(self.selected)
        if n == 0:
            raise ValueError("empty selection")
        epoch = (step * batch_size) // n
        rng = np.random.default_rng((self.seed, epoch))
        perm = rng.permutation(n)
        idx = [(step * batch_size + i) % n for i in range(batch_size)]
        rows = self.selected[perm[idx]]
        toks = self.corpus.tokens[self.row_perm[rows]][:, :seq_len]
        return {"tokens": toks.astype(np.int32)}

    # -- paper-effect reporting ----------------------------------------------
    def index_stats(self) -> Dict[str, float]:
        unsorted = BitmapIndex.build(
            self.corpus.fact_table, k=1, cards=self.corpus.cards)
        return {
            "index_words": float(self.index.size_words),
            "index_words_unsorted": float(unsorted.size_words),
            "compression_gain": unsorted.size_words / max(self.index.size_words, 1),
            "n_bitmaps": float(self.index.n_bitmaps),
        }
