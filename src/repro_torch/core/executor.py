"""Physical executor: run a plan over EWAH bitmaps or the device kernel.

Per-node backend choice (Roaring's lesson, arXiv:1402.6407 — pick the
physical representation per operation, by density, not globally): an n-ary
AND/OR or AND-NOT whose operands are mostly *dense* (compressed size close
to the uncompressed word count, so EWAH's run-skipping buys nothing) is
offloaded to the fused ``logical_reduce`` kernel, one launch that reads
every operand row where it lies, on the executor's device (``device``:
``"cuda"`` by default, ``"cpu"`` for the plain versions — asked for, never
fallen back to); sparse operands stay on the compressed EWAH path — the
vectorized run-list ops in ``repro_torch.core.ewah`` — where cost is
O(non-zero words) (Lemma 2).  The decision reads the operands' actual
compressed sizes, which the index already tracks, against the **measured**
crossover density from ``repro_torch.core.cost_model`` (calibrated per
machine; static 0.5 fallback when no calibration has run).

Kernel-path operands are padded to power-of-two word-count buckets and
cached *with* their per-row clean-block flags, as tensors on the device,
in the index's ``dense_cache`` (``("dense", device, col, bid, bucket)``
entries): each bitmap is decompressed, flagged and uploaded once per
device, not once per query or statement, and handed to the kernel as
lists of rows (see ``repro_torch.kernels.ops``).  The reduction's one
result row comes back to the host for ``EWAH.from_words``.

``QueryBatch`` evaluates many expressions in one pass over a shared operand
cache: physical bitmaps (and their bucketed dense decompressions + flags,
when the kernel path is taken) are loaded once and reused across all plans
in the batch.  Constant plan nodes memoize their full-length bitmaps in the
same cache.  Sharded execution forwards an optional worker pool for
shard-parallel fan-out (``repro_torch.core.shard``), and every dispatcher
hands its ``device`` to the executor of each shard and live layer.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.kernels import _trace
from repro_torch.kernels import ops as kops
from . import cost_model as _cm
from . import measures as _ms
from .ewah import EWAH, and_many, or_many
from .expr import Expr
from .index import BitmapIndex
from .planner import (PAgg, PAnd, PBitmap, PConst, PCount, PDiff,
                      PGroupAgg, PNot, POr, PPinned, PlanNode)

# the historical static threshold, kept as the uncalibrated fallback; the
# live value comes from ``repro_torch.core.cost_model`` (measured crossover when a
# calibration has been persisted on this machine)
DENSE_THRESHOLD = _cm.DEFAULT_DENSE_THRESHOLD

Backend = str  # "auto" | "ewah" | "kernel"

# caps on memoized subexpression results per operand cache: leaf entries
# are bounded by the index itself, but composite results are keyed by query
# shape, and a long-lived cache (a process-pool worker's, a persistent
# batch cache) serving a varied stream would otherwise grow without bound —
# both an entry cap and a byte budget over the cached EWAH payloads apply
SUB_CACHE_ENTRIES = 512
SUB_CACHE_BYTES = 32 << 20
_SUB_ORDER_KEY = ("sub_order",)
_SUB_BYTES_KEY = ("sub_bytes",)


def _const_bitmap(index: BitmapIndex, value: bool,
                  cache: Optional[Dict] = None) -> EWAH:
    """All-ones / all-zeros bitmap over the index's rows, memoized per
    (index rows, value) in the operand cache — constant plan nodes used to
    rebuild a full-length EWAH on every evaluation."""
    key = ("const", index.n_rows, value)
    if cache is not None:
        bm = cache.get(key)
        if bm is not None:
            return bm
    bm = EWAH.from_bool(np.full(index.n_rows, value, dtype=bool))
    if cache is not None:
        cache[key] = bm
    return bm


class Executor:
    def __init__(self, index: BitmapIndex, backend: Backend = "auto",
                 cache: Optional[Dict] = None,
                 dense_threshold: Optional[float] = None,
                 device: Union[str, torch.device] = "cuda"):
        if backend not in ("auto", "ewah", "kernel"):
            raise ValueError(f"backend must be auto, ewah or kernel, "
                             f"got {backend!r}")
        self.index = index
        self.backend = backend
        self.device = kops.resolve_device(device)
        self.cache = cache if cache is not None else {}
        # None -> the process cost model (calibrated crossover if available)
        self.dense_threshold = (
            _cm.get_default().dense_threshold
            if dense_threshold is None else dense_threshold)

    # -- operand loading (shared across a batch via ``cache``) ------------
    def _load(self, node: PBitmap) -> EWAH:
        key = ("bm", node.col, node.bitmap_id)
        bm = self.cache.get(key)
        if bm is None:
            bm = self.index.bitmap(node.col, node.bitmap_id)
            self.cache[key] = bm
        return bm

    def _dense_operand(self, node: PlanNode, bm: EWAH):
        """(bucket-padded words, per-row clean flags) on the device, for
        the kernel path.

        A physical bitmap's pair is cached in the index's ``dense_cache``
        per device *and bucket*, so it is decompressed, flagged and
        uploaded once for the index's lifetime, whatever the statement or
        backend; composite operands are built per use."""
        cp = kops.bucket_cols(bm.n_words_uncompressed)
        if isinstance(node, PBitmap):
            key = ("dense", str(self.device), node.col, node.bitmap_id, cp)
            cache = self.index.dense_cache
            hit = cache.get(key)
            if hit is None:
                with _trace.span("kernel.upload"):
                    hit = self._pad_and_flags(bm, cp, self.device)
                cache[key] = hit
            return hit
        with _trace.span("kernel.upload"):
            return self._pad_and_flags(bm, cp, self.device)

    @staticmethod
    def _pad_and_flags(bm: EWAH, cp: int, device: torch.device):
        with _trace.span("ewah.to_words"):
            w = bm.to_words()
        if len(w) < cp:
            w = np.pad(w, (0, cp - len(w)))
        if bm._cont is not None and bm._words is None:
            # container-backed: flags come off the chunk directory (EMPTY/
            # FULL/ARRAY chunks never scan words), bit-identical to below
            flags = kops.container_row_flags(bm._cont, len(w))
        else:
            flags = kops.np_row_flags(w)
        return (kops.to_device_words(w, device),
                torch.from_numpy(flags).to(device))

    # -- evaluation --------------------------------------------------------
    def run(self, node: PlanNode) -> EWAH:
        """Evaluate a plan tree to an EWAH result.

        The top-level statement *reads* the subexpression cache (it may be
        a subtree of an earlier statement) but does not write its own
        result into it — whole-result caching belongs to the dedicated
        result LRUs, and an operand cache that also memoized roots would
        silently turn repeat-latency measurements into dictionary lookups.
        Strict subtrees are cached (see ``_run``)."""
        return self._run(node, write=False)

    def _run(self, node: PlanNode, write: bool = True) -> EWAH:
        if isinstance(node, PConst):
            return _const_bitmap(self.index, node.value, self.cache)
        if isinstance(node, PBitmap):
            return self._load(node)
        if isinstance(node, PPinned):
            # an externally-evaluated bitmap (live-ingest tombstone masks);
            # its ckey is None, so no enclosing subtree caches around it
            return node.bitmap
        # composite subtrees memoize by canonical plan key: a subexpression
        # shared across a batch's statements (same ``ckey``, possibly under
        # commutative reordering) is evaluated exactly once per cache; the
        # counters ``executor.sub_hits`` / ``sub_misses`` show the sharing
        key = ("sub", node.ckey) if node.ckey is not None else None
        if key is not None:
            hit = self.cache.get(key)
            if hit is not None:
                _trace.count("executor.sub_hits")
                return hit
            _trace.count("executor.sub_misses")
        bm = self._run_composite(node)
        if key is not None and write:
            # FIFO-bounded by entries *and* result bytes: the eviction
            # bookkeeping lives in the cache dict itself so the bounds
            # follow the cache's lifetime, not the (per-call) executor's.
            # Races on a shared dict are as benign as the rest of the
            # operand cache — worst case a subtree recomputes once.
            order = self.cache.setdefault(_SUB_ORDER_KEY, [])
            if key not in self.cache:
                order.append(key)
                self.cache[key] = bm
                total = self.cache.get(_SUB_BYTES_KEY, 0) + bm.size_bytes
                while order and (len(order) > SUB_CACHE_ENTRIES
                                 or total > SUB_CACHE_BYTES):
                    old = self.cache.pop(order.pop(0), None)
                    if old is not None:
                        total -= old.size_bytes
                self.cache[_SUB_BYTES_KEY] = max(total, 0)
            else:
                self.cache[key] = bm
        return bm

    def _run_composite(self, node: PlanNode) -> EWAH:
        if isinstance(node, PNot):
            child = self._run(node.child)
            _trace.count("executor.nodes_ewah")
            with _trace.span("exec.ewah_node", op="not", rows=1):
                return ~child
        if isinstance(node, PDiff):
            return self._run_diff(node)
        assert isinstance(node, (PAnd, POr))
        op = "and" if isinstance(node, PAnd) else "or"
        children = [(ch, self._run(ch)) for ch in node.children]
        if self._use_kernel([bm for _, bm in children]):
            return self._reduce_kernel(children, op)
        bms = [bm for _, bm in children]
        _trace.count("executor.nodes_ewah")
        with _trace.span("exec.ewah_node", op=op, rows=len(bms)):
            return and_many(bms) if op == "and" else or_many(bms)

    # -- aggregation (compressed domain) -----------------------------------
    def run_count(self, node: PCount) -> int:
        """COUNT(*): the filter's memoized compressed-domain popcount —
        no row ids, no result materialization."""
        child = node.child
        if isinstance(child, PConst):
            return self.index.n_rows if child.value else 0
        # the filter is a *subexpression* of the count statement: cached,
        # so a row query or group-by over the same filter reuses it
        with _trace.span("exec.filter"):
            return self._run(child).count()

    def _filter_intervals(self, filt: Optional[PlanNode]):
        """A filter node's set-bit intervals, ``None`` filters covering all
        rows; returns empty arrays for an all-false filter."""
        if isinstance(filt, PConst):
            if not filt.value:
                return (np.empty(0, dtype=np.int64),
                        np.empty(0, dtype=np.int64))
            filt = None
        if filt is None:
            n = self.index.n_rows
            if not n:
                return (np.empty(0, dtype=np.int64),
                        np.empty(0, dtype=np.int64))
            return (np.asarray([0], dtype=np.int64),
                    np.asarray([n], dtype=np.int64))
        return self._run(filt).set_intervals()

    def run_agg(self, node: PAgg):
        """Scalar ``(sum, count, min, max)`` of a measure under the node's
        filter: the filter's run intervals slice the mmap'd measure array
        directly (one gather, three reductions) — no row ids, no result
        bitmap, no row reconstruction."""
        values = self.index.measure(node.measure)
        with _trace.span("exec.filter"):
            fs, fe = self._filter_intervals(node.filter)
        return _ms.reduce_intervals(values, fs, fe)

    def run_group_agg(self, node: PGroupAgg) -> Dict:
        """Grouped aggregates over one or two columns in the filtered
        domain.

        The filter's intervals define a dense coordinate space of
        ``count(filter)`` positions; the measure is gathered into it once
        and prefix-summed, so every group's sum is two subtractions and its
        min/max one segmented ``reduceat``.  Each grouping column's rank
        bitmaps *partition* the rows (every row holds exactly one value),
        so their intervals, merged, are the column's run-length encoding:
        a run catalog built once per index (``_run_catalog``) that the
        filter's intervals probe for the runs they meet, in filtered
        coordinates.  One column accumulates per-rank segments directly;
        two columns sweep the *elementary segments* induced by both
        columns' boundaries, binning each into its ``(rank_a, rank_b)``
        cell — cost O(selected rows + runs met), never O(card_a * card_b
        * rows) nor O(card) value bitmaps a statement.
        """
        cards = tuple(len(g) for g in node.groups)
        name = node.measure
        values = self.index.measure(name) if name is not None else None
        dt = _ms.measure_dtype_str(values) if values is not None else None
        out = _ms.empty_group_agg(node.cols, cards, name, dt)
        with _trace.span("exec.filter"):
            fs, fe = self._filter_intervals(node.filter)
        if not len(fs):
            return out
        F = int((fe - fs).sum())
        # per-column segments in filtered coordinates, sorted by start
        # (segments of one column are disjoint and cover [0, F))
        catalogs = []
        for c, groups in zip(node.cols, node.groups):
            with _trace.span("groupby.catalog", col=c):
                starts, ranks = self._run_catalog(c, groups)
                cat = _ms.probe_catalog(starts, ranks, self.index.n_rows,
                                        fs, fe)
                _trace.count("groupby.value_bitmaps", len(groups))
                _trace.count("groupby.value_bitmaps_met", int(
                    np.count_nonzero(np.bincount(cat[2]))))
            catalogs.append(cat)
        with _trace.span("groupby.cells"):
            self._group_cells(out, catalogs, cards, F, values, fs, fe)
        return out

    def _run_catalog(self, c: int, groups: Sequence[PlanNode]):
        """Column ``c``'s run catalog, built from its value nodes' set-bit
        intervals at the first group-by over it and memoized on the
        index's ``ColumnIndex`` (counters ``groupby.catalog_builds`` and
        ``groupby.catalog_probes``)."""
        cat, built = self.index.columns[c].run_catalog(
            lambda: _ms.run_catalog([self._run(gn).set_intervals()
                                     for gn in groups], self.index.n_rows))
        _trace.count("groupby.catalog_builds" if built
                     else "groupby.catalog_probes")
        return cat

    @staticmethod
    def _group_cells(out: Dict, catalogs, cards, F: int, values, fs, fe):
        """Bin the filtered domain's segments into ``out``'s cells: the
        measure gathered into filtered coordinates and prefix-summed, each
        segment's sum two subtractions, its min/max one ``reduceat``."""
        fvals = _ms.gather(values, fs, fe) if values is not None else None
        pref = _ms.prefix_sums(fvals) if fvals is not None else None
        if len(catalogs) == 1:
            S, E, R = catalogs[0]
            cell = R
            size = cards[0]
        else:
            # elementary segments: boundaries wherever either column
            # changes rank; each segment is homogeneous in both columns
            (sa, _, ra), (sb, _, rb) = catalogs
            S = np.unique(np.concatenate([sa, sb]))
            E = np.concatenate([S[1:], [F]]).astype(np.int64)
            ia = np.searchsorted(sa, S, side="right") - 1
            ib = np.searchsorted(sb, S, side="right") - 1
            cell = ra[ia] * cards[1] + rb[ib]
            size = cards[0] * cards[1]
        out["counts"] += np.bincount(cell, weights=(E - S),
                                     minlength=size).astype(np.int64)
        if values is not None:
            # np.add.at (not bincount) keeps int64 sums exact past 2^53
            np.add.at(out["sums"], cell, pref[E] - pref[S])
            mins, maxs = _ms.segmented_min_max(fvals, S, E)
            np.minimum.at(out["mins"], cell, mins)
            np.maximum.at(out["maxs"], cell, maxs)

    def _run_diff(self, node: PDiff) -> EWAH:
        """AND(pos) \\ OR(neg): one fused kernel launch on the dense path,
        EWAH's native andnot otherwise — negated operands never
        materialize their complements."""
        pos = [(ch, self._run(ch)) for ch in node.pos]
        neg = [(ch, self._run(ch)) for ch in node.neg]
        rows = len(pos) + len(neg)
        if self._use_kernel([bm for _, bm in pos + neg]):
            _trace.count("executor.nodes_kernel")
            with _trace.span("exec.kernel_node", op="andnot", rows=rows):
                pw, pf = zip(*[self._dense_operand(n, bm) for n, bm in pos])
                nw, nf = zip(*[self._dense_operand(n, bm) for n, bm in neg])
                with _trace.span("kernel.launch"):
                    res = kops.diff_reduce(pw, pf, nw, nf)
                return self._from_device(res, pos[0][1])
        _trace.count("executor.nodes_ewah")
        with _trace.span("exec.ewah_node", op="andnot", rows=rows):
            acc = and_many([bm for _, bm in pos])
            for _, bm in neg:
                acc = acc.andnot(bm)
            return acc

    def _use_kernel(self, bms: Sequence[EWAH]) -> bool:
        if self.backend == "ewah":
            return False
        n_words = bms[0].n_words_uncompressed
        if n_words == 0:
            # zero-row operands (e.g. an empty shard): nothing to reduce
            # densely, and the kernel has no zero-size tiles
            return False
        if self.backend == "kernel":
            return True
        density = sum(bm.size_words for bm in bms) / (len(bms) * n_words)
        return len(bms) >= 2 and density >= self.dense_threshold

    def _reduce_kernel(self, children, op: str) -> EWAH:
        _trace.count("executor.nodes_kernel")
        with _trace.span("exec.kernel_node", op=op, rows=len(children)):
            ws, fs = zip(*[self._dense_operand(node, bm)
                           for node, bm in children])
            with _trace.span("kernel.launch"):
                res = kops.logical_reduce(ws, op=op, row_flags=fs)
            return self._from_device(res, children[0][1])

    @staticmethod
    def _from_device(res: torch.Tensor, like: EWAH) -> EWAH:
        """A kernel's result row back on the host, as an EWAH of
        ``like``'s length."""
        with _trace.span("kernel.download"):
            out = kops.to_numpy_words(res)
        with _trace.span("ewah.from_words"):
            return EWAH.from_words(out[:like.n_words_uncompressed],
                                   like.n_bits)


def _shard_caches(index, cache: Optional[Dict]) -> Optional[List[Dict]]:
    """Per-shard operand sub-dicts inside one caller-supplied cache, so a
    persistent cache keeps sharing operands across calls on every
    statement path (one keying scheme, used by all dispatchers)."""
    if cache is None:
        return None
    return [cache.setdefault(("shard", i), {})
            for i in range(index.n_shards)]


# the method of a sharded or live index that runs each statement kind
_INDEX_METHODS = {"expr": "execute", "count": "count",
                  "gcount": "group_count", "agg": "agg", "gagg": "group_agg"}


def _run_statement(index, task, backend: Backend, optimize: bool,
                   cache: Optional[Dict], pool, device):
    """One statement task (see ``repro_torch.core.shard.run_shard_task``)
    on any index: a ``LiveIndex`` or ``ShardedIndex`` through its method of
    the task's kind (per-shard partials merged at the coordinator, a
    caller's ``cache`` split per shard), a monolithic ``BitmapIndex`` as
    one shard."""
    # local: shard and ingest import this module
    from .shard import ShardedIndex, run_shard_task
    from .ingest import LiveIndex
    method = _INDEX_METHODS[task[0]]
    if isinstance(index, LiveIndex):
        return getattr(index, method)(*task[1:], backend=backend,
                                      optimize=optimize, pool=pool,
                                      device=device)
    if isinstance(index, ShardedIndex):
        return getattr(index, method)(*task[1:], backend=backend,
                                      optimize=optimize,
                                      caches=_shard_caches(index, cache),
                                      pool=pool, device=device)
    return run_shard_task(index, task, backend=backend, optimize=optimize,
                          cache=cache, device=device)


def execute(index, e: Union[Expr, PlanNode],
            backend: Backend = "auto", optimize: bool = True,
            cache: Optional[Dict] = None, pool=None, device="cuda") -> EWAH:
    """Plan (unless given a plan) and evaluate one expression -> EWAH.

    Accepts a monolithic ``BitmapIndex``, a ``ShardedIndex`` or a
    ``LiveIndex``; the sharded path plans and executes per shard —
    concurrently when ``pool`` (a ``concurrent.futures`` executor or a
    ``ShardProcessPool``) is given — then concatenates the EWAH results.
    """
    return _run_statement(index, ("expr", e), backend, optimize, cache, pool,
                          device)


def execute_rows(index, e: Union[Expr, PlanNode],
                 backend: Backend = "auto", optimize: bool = True,
                 device="cuda") -> np.ndarray:
    """Evaluate and return matching row ids (sorted)."""
    return execute(index, e, backend=backend, optimize=optimize,
                   device=device).set_bits()


def execute_count(index, e: Optional[Expr] = None,
                  backend: Backend = "auto", optimize: bool = True,
                  cache: Optional[Dict] = None, pool=None,
                  device="cuda") -> int:
    """COUNT(*) of a filter (``e=None`` counts all rows), computed in the
    compressed domain — on a ``ShardedIndex`` per-shard partial counts are
    summed at the coordinator, never a concatenated result bitmap."""
    return _run_statement(index, ("count", e), backend, optimize, cache,
                          pool, device)


def execute_group_count(index, col, e: Optional[Expr] = None,
                        backend: Backend = "auto", optimize: bool = True,
                        cache: Optional[Dict] = None, pool=None,
                        device="cuda") -> np.ndarray:
    """GROUP BY ``col`` COUNT(*) under filter ``e`` -> int64 array of
    length ``card(col)`` (a ``np.bincount``-shaped result): the ``counts``
    of the one-column group-by, from the column's run catalog.  Sharded
    indexes merge per-shard partial count vectors by summation."""
    return _run_statement(index, ("gcount", col, e), backend, optimize,
                          cache, pool, device)


def execute_agg(index, measure: str, e: Optional[Expr] = None,
                backend: Backend = "auto", optimize: bool = True,
                cache: Optional[Dict] = None, pool=None, device="cuda"):
    """Scalar ``(sum, count, min, max)`` of ``measure`` under filter ``e``
    (``e=None`` aggregates all rows), computed by interval-slicing the
    measure sidecar — sharded indexes merge per-shard partial tuples at
    the coordinator (``repro_torch.core.measures.merge_scalar_aggs``)."""
    return _run_statement(index, ("agg", measure, e), backend, optimize,
                          cache, pool, device)


def execute_group_agg(index, measure: Optional[str], cols,
                      e: Optional[Expr] = None,
                      backend: Backend = "auto", optimize: bool = True,
                      cache: Optional[Dict] = None, pool=None,
                      device="cuda") -> Dict:
    """GROUP BY one or two columns, aggregating ``measure`` (or counting
    rows when ``measure`` is ``None``) under filter ``e``.  Returns the
    partial-aggregate dict of ``Executor.run_group_agg``; project it onto
    one op with ``repro_torch.core.measures.finalize_group``.  Sharded
    indexes merge per-shard partials elementwise."""
    return _run_statement(index, ("gagg", measure, cols, e), backend,
                          optimize, cache, pool, device)


class QueryBatch:
    """Evaluate many expressions in one pass sharing loaded operands.

    Plans are built up front, then all plans execute against one operand
    cache, so a bitmap referenced by several queries (the common case for
    dashboard-style workloads: same dimensions, different slices) is
    concatenated from its partitions — and uploaded, on the kernel path —
    exactly once.
    """

    def __init__(self, exprs: Sequence[Expr]):
        self.exprs = list(exprs)

    def execute(self, index, backend: Backend = "auto",
                optimize: bool = True, pool=None,
                device="cuda") -> List[EWAH]:
        cache: Dict = {}  # one operand cache (split per shard) per batch
        return [execute(index, e, backend=backend, optimize=optimize,
                        cache=cache, pool=pool, device=device)
                for e in self.exprs]

    def execute_rows(self, index, backend: Backend = "auto",
                     optimize: bool = True, pool=None,
                     device="cuda") -> List[np.ndarray]:
        return [bm.set_bits()
                for bm in self.execute(index, backend=backend,
                                       optimize=optimize, pool=pool,
                                       device=device)]
