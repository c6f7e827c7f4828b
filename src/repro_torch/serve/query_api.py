"""Query-serving endpoint over a (possibly sharded) bitmap index.

Production-shaped serving on a dependency-free stack (stdlib ``http.server``
+ the core query stack):

* ``QueryService`` — programmatic facade: parse a JSON expression, execute it
  on a bounded ``ThreadPoolExecutor`` worker pool, return rows + stats.
  Results are memoized in an LRU cache keyed by the *structural* canonical
  key of the expression (``repro_torch.core.expr.canonical_key``), so a repeated —
  or commutatively reordered — query is served from cache without touching
  a bitmap.  The cache evicts by **total EWAH bytes** (``cache_bytes``), not
  just entry count — results span orders of magnitude in size — and the
  byte budget + live usage are exposed in ``/stats``.  Swapping in a rebuilt
  index (``set_index``) invalidates the cache atomically via a generation
  counter; ``replace_shard`` swaps one shard and keeps the other shards'
  local result caches warm.  The index may be a monolithic ``BitmapIndex``
  or a ``ShardedIndex``; sharded execution fans out on a dedicated shard
  pool (shard tasks submit no further work, so the two pools cannot
  deadlock).
* **Warm start** — ``--index-dir`` opens a saved, memory-mapped sharded
  store (``repro_torch.core.store``) at boot: no sort, no rebuild, serving starts
  in milliseconds and bitmap pages fault in on first touch.  ``--save-index``
  builds the demo index once, persists it, and serves from the mmap — the
  build-once / serve-many flow.  ``POST /admin/reload`` re-stats the shard
  files and swaps in any that changed on disk (an atomically-replaced shard
  file from an out-of-band reindex), keeping the *other* shards' caches
  warm; ``--watch-interval N`` runs the same manifest/shard-fingerprint
  check on a background poller so replaced files are picked up with no
  admin call.  On a store directory, shard fan-out defaults to a
  fork-based ``ShardProcessPool`` on ``--device cpu`` (workers mmap-open
  the shard files and are pinned to the fork-safe EWAH backend) and to the
  thread pool on CUDA; ``--shard-procs 0`` forces the thread pool.
  Result-cache entries can also expire after ``--cache-ttl`` seconds
  (lazily, on lookup), with hit/miss/expired counters in ``/stats``.
* **Aggregation statements** — count / group-by / top-k evaluate *in the
  compressed domain* (memoized popcounts + interval intersection; sharded
  indexes merge per-shard partial counts at the coordinator, never a global
  result bitmap) and are cached like row queries, keyed by the statement
  kind plus the filter's canonical key.
* **Live ingest** — ``/ingest`` and ``/delete`` mutate the served dataset
  through the WAL-backed LSM layer (``repro_torch.core.ingest.LiveIndex``):
  appends land in an in-memory delta index, deletes in compressed per-shard
  tombstones, every mutation durably framed in a write-ahead log *first* so
  a crashed service replays to its exact pre-crash state on warm start.
  Queries keep evaluating in the compressed domain across the
  ``(base ⊔ delta) AND NOT tombstones`` merge; a background ``Compactor``
  (``--live``) folds the delta into freshly sorted shard files and
  truncates the WAL, with the manifest rewrite as the atomic cutover.
* ``serve()`` — a threaded HTTP server exposing the service:
    POST /query             {"query": <expr>}          -> one row result
    POST /query             {"queries": [<expr>, ...]} -> batched results
    POST /query             {"select": <sel>, "where": <expr>?} -> aggregate
    POST /ingest            {"rows": [[...], ...]}     -> durable append
    POST /delete            {"where": <expr>}          -> durable delete
    POST /admin/compact                                -> compact now
    POST /admin/invalidate                             -> drop the result cache
    POST /admin/reload                                 -> reopen changed shards
    POST /admin/optimize    {"col_order"?, "remap"?}   -> rewrite the store
                                                          into the advisor's
                                                          layout, rolling swap
    GET  /healthz                                      -> liveness
    GET  /stats                                        -> index + cache stats
                                                          (+ live/compaction)

Wire format for expressions (mirrors the AST):
    {"op": "eq", "col": 0, "value": 3}
    {"op": "in", "col": "region", "values": [1, 2]}
    {"op": "range", "col": 1, "lo": 10, "hi": 20}        # either bound opt.
    {"op": "and"|"or", "args": [<expr>, ...]}
    {"op": "not", "arg": <expr>}

and for aggregate selects (the ``where`` clause is optional everywhere):
    {"select": {"count": true}, "where": <expr>}
    {"select": {"group_count": "region"}, "where": <expr>}
    {"select": {"top_k": {"col": "region", "k": 5}}, "where": <expr>}

Measure statements (OLAP over the columnar measure sidecar, evaluated in
the compressed domain by slicing mmap'd measure arrays with the filter's
``set_intervals()`` — no row reconstruction):
    {"select": {"sum": "sales"}, "where": <expr>}            # also avg/min/max
    {"select": {"sum": "sales", "by": ["day", "region"]}}    # 1-2 group cols
    {"select": {"count": true, "by": ["day", "region"]}}     # multi-col counts
    {"select": {"top_k": {"col": "region", "k": 5,
                          "measure": "sales"}}}              # rank by SUM
A top-level ``"limit": k`` turns a single-column count/sum group-by into
the equivalent shard-pruned top-k.  ``{"sql": "SELECT sum(sales) FROM t
WHERE day = 3 GROUP BY region LIMIT 5"}`` translates the SQL-ish form
(``parse_sql``) into exactly these statements.

Devices: the service runs every statement's kernel path (the executor's
dense n-ary AND/OR and AND-NOT, ``csrc/logical_reduce.cu``) on its
``device`` — ``"cuda"`` unless the caller passes ``"cpu"``, which runs the
plain versions; naming CUDA without a card raises, and a failed build or
launch fails the statement (there is no fallback to ``ewah``).  The fork
rule of ``repro_torch.core.shard`` decides the default shard pool: forked
``ShardProcessPool`` workers run the host EWAH path on the CPU and never
call CUDA, so a service on a CUDA device keeps its shards in-process (the
kernel path, on the card); only a store-backed sharded service on
``device="cpu"`` defaults to the process pool, as the reference's does.
In-process, a statement runs its shards one after another in its own
worker thread: the host's share of a shard task (planning, words to runs,
the group-by probes) holds the GIL and the device's share takes
microseconds, so shard threads would only take turns and hand the GIL
over.  An explicit ``shard_processes`` > 0 on CUDA still forks, and there
``auto`` degrades to ``ewah`` and ``kernel`` raises ``ForkSafetyError``.

Run standalone against a synthetic sorted table:
    PYTHONPATH=src python -m repro_torch.serve.query_api --port 8321 --shards 4
Build once, then warm-start serve:
    PYTHONPATH=src python -m repro_torch.serve.query_api --shards 4 --save-index /tmp/idx
    PYTHONPATH=src python -m repro_torch.serve.query_api --index-dir /tmp/idx
(add ``--device cpu`` on a machine without a CUDA card).
"""
from __future__ import annotations

import argparse
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import BitmapIndex, ShardedIndex, lex_sort, synth
from repro_torch.core import cost_model
from repro_torch.core import measures as measures_mod
from repro_torch.core import store as index_store
from repro_torch.core.dataset import top_k_from_counts, top_k_from_values
from repro_torch.core.expr import Expr, canonical_key, from_wire, to_wire
from repro_torch.core.executor import (execute, execute_agg, execute_count,
                                 execute_group_agg, execute_group_count)
from repro_torch.core.lru import LRUCache, payload_kind, payload_nbytes
from repro_torch.core.planner import explain, plan
from repro_torch.kernels import _trace
from repro_torch.kernels.ops import resolve_device

DEFAULT_CACHE_BYTES = 64 << 20  # total EWAH payload budget for the result LRU

Device = Union[str, torch.device]


def parse_expr(obj: Dict) -> Expr:
    """JSON wire format -> Expr tree (raises ValueError on malformed input).

    Alias of ``repro_torch.core.expr.from_wire`` — one wire codec shared by the
    HTTP layer and the write-ahead log's delete frames."""
    return from_wire(obj)


def expr_to_json(e: Expr) -> Dict:
    """Inverse of ``parse_expr`` (alias of ``repro_torch.core.expr.to_wire``)."""
    return to_wire(e)


_AGG_OPS = ("sum", "avg", "min", "max")


def parse_statement(obj: Dict) -> Dict:
    """``{"select": ..., "where": ..., "limit": ...}`` -> statement
    descriptor.

    Returns a dict with keys ``kind`` (``"count"`` / ``"group_count"`` /
    ``"agg"`` / ``"group_agg"`` / ``"top_k"``), ``op`` (``sum`` / ``avg``
    / ``min`` / ``max`` / ``count`` for measure statements), ``measure``,
    ``col``, ``by`` (grouping column list), ``k`` and ``where`` (parsed
    ``Expr``) — None where not applicable.  A top-level ``limit`` rewrites
    a single-column count/sum group-by into the equivalent top-k (the
    shard-prunable ranking ops).  Raises ValueError on malformed
    statements (mapped to HTTP 400).
    """
    sel = obj.get("select")
    if not isinstance(sel, dict):
        raise ValueError(
            f"'select' must be an object naming one of count / group_count "
            f"/ top_k / sum / avg / min / max: {sel!r}")
    where = obj.get("where")
    e = parse_expr(where) if where is not None else None
    by = sel.get("by")
    keys = [k for k in sel if k != "by"]
    if len(keys) != 1:
        raise ValueError(
            f"'select' must name exactly one of count / group_count / "
            f"top_k / sum / avg / min / max (plus an optional 'by'): "
            f"{sel!r}")
    kind, arg = keys[0], sel[keys[0]]
    if by is not None:
        if isinstance(by, (str, int)) and not isinstance(by, bool):
            by = [by]
        if (not isinstance(by, list) or not (1 <= len(by) <= 2)
                or any(isinstance(c, bool) or not isinstance(c, (str, int))
                       for c in by)):
            raise ValueError(
                f"'by' must list 1 or 2 grouping columns, got {by!r}")
    out = {"kind": None, "op": None, "measure": None, "col": None,
           "by": None, "k": None, "where": e}
    if kind == "count":
        if arg is not True:
            raise ValueError('use {"count": true}')
        if by is None:
            out["kind"] = "count"
        else:
            out.update(kind="group_agg", op="count", by=by)
    elif kind in _AGG_OPS:
        if not isinstance(arg, str) or not arg:
            raise ValueError(f"{kind} needs a measure name, got {arg!r}")
        out.update(op=kind, measure=arg)
        if by is None:
            out["kind"] = "agg"
        else:
            out.update(kind="group_agg", by=by)
    elif by is not None:
        raise ValueError(f"'by' does not combine with {kind!r}")
    elif kind == "group_count":
        _check_col(arg, "group_count")
        out.update(kind="group_count", col=arg)
    elif kind == "top_k":
        if not (isinstance(arg, dict) and "col" in arg and "k" in arg):
            raise ValueError(
                f'top_k needs {{"col": ..., "k": ...}}, got {arg!r}')
        _check_col(arg["col"], "top_k")
        m = arg.get("measure")
        if m is not None and (not isinstance(m, str) or not m):
            raise ValueError(f"top_k 'measure' must be a name, got {m!r}")
        out.update(kind="top_k", col=arg["col"], k=int(arg["k"]), measure=m)
    else:
        raise ValueError(f"unknown select {kind!r}")
    return _apply_limit(out, obj.get("limit"))


# the prefix of the per-kind statement counters, ``statements/<kind>/n``
# and ``statements/<kind>/seconds``
_STATEMENTS = "statements/"


def statement_kind(obj: Dict) -> str:
    """A valid wire statement's kind as its ``select`` names it, with the
    number of grouping columns: ``count``, ``sum.by2``, ``top_k``."""
    sel = obj["select"]
    by = sel.get("by")
    kind = next(k for k in sel if k != "by")
    if by is None:
        return kind
    return f"{kind}.by{1 if isinstance(by, (str, int)) else len(by)}"


def _apply_limit(st: Dict, limit) -> Dict:
    """Rewrite ``limit`` on a single-column group statement into the
    equivalent top-k (count and sum rankings — the ops shard pruning can
    bound; an avg/min/max ranking has no monotone partial)."""
    if limit is None:
        return st
    if isinstance(limit, bool) or not isinstance(limit, int) or limit < 1:
        raise ValueError(f"'limit' must be a positive integer, got {limit!r}")
    if st["kind"] == "group_count":
        return {**st, "kind": "top_k", "k": int(limit), "measure": None}
    if (st["kind"] == "group_agg" and st["by"] is not None
            and len(st["by"]) == 1 and st["op"] in ("count", "sum")):
        return {**st, "kind": "top_k", "col": st["by"][0], "by": None,
                "k": int(limit), "measure": st["measure"]}
    if st["kind"] == "top_k":
        return {**st, "k": min(st["k"], int(limit))}
    raise ValueError(
        "'limit' ranks a single-column count or sum group-by (top-k); it "
        "cannot truncate a scalar, a two-column matrix, or an avg/min/max "
        "ranking")


def _check_col(arg, kind: str) -> None:
    # bool is a subclass of int: {"group_count": true} (a typo'd copy of
    # the count shape) must be a 400, not a query against column 1
    if isinstance(arg, bool) or not isinstance(arg, (str, int)):
        raise ValueError(f"{kind} needs a column name or position, "
                         f"got {arg!r}")


def nan_to_none(x):
    """Recursively replace NaN (empty avg/min/max cells) with None so
    grouped results serialize as strict JSON ``null``."""
    if isinstance(x, list):
        return [nan_to_none(v) for v in x]
    if isinstance(x, float) and x != x:
        return None
    return x


# -- SQL-ish front door ------------------------------------------------------

def _sql_tokens(sql: str) -> List[tuple]:
    import re
    out: List[tuple] = []
    i, n = 0, len(sql)
    while i < n:
        ch = sql[i]
        if ch.isspace():
            i += 1
            continue
        if ch in "(),=*":
            out.append((ch, ch))
            i += 1
            continue
        m = re.match(r"[A-Za-z_][A-Za-z0-9_]*", sql[i:])
        if m:
            out.append(("ident", m.group(0)))
            i += len(m.group(0))
            continue
        m = re.match(r"-?\d+", sql[i:])
        if m:
            out.append(("int", int(m.group(0))))
            i += len(m.group(0))
            continue
        raise ValueError(f"SQL: unexpected character {ch!r} at offset {i}")
    out.append(("end", None))
    return out


class _SqlParser:
    """Recursive-descent parser for the SQL-ish statement subset::

        SELECT count(*) | sum(m) | avg(m) | min(m) | max(m)
        FROM <table>                      -- single-table engine: name ignored
        [WHERE <pred>]                    -- =, IN (...), BETWEEN a AND b,
                                          --   AND / OR / NOT, parentheses
        [GROUP BY a[, b]]
        [LIMIT k]

    Values are integer *ranks* (the dictionary-encoded domain the bitmap
    index stores).  Produces the JSON statement object ``parse_statement``
    accepts, so SQL and JSON front doors share one semantics."""

    def __init__(self, sql: str):
        self.toks = _sql_tokens(sql)
        self.pos = 0

    def peek(self) -> tuple:
        return self.toks[self.pos]

    def next(self) -> tuple:
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def at_kw(self, word: str) -> bool:
        t, v = self.peek()
        return t == "ident" and v.upper() == word

    def expect_kw(self, word: str) -> None:
        if not self.at_kw(word):
            raise ValueError(f"SQL: expected {word}, got {self.peek()[1]!r}")
        self.next()

    def expect(self, typ: str):
        t, v = self.next()
        if t != typ:
            raise ValueError(f"SQL: expected {typ!r}, got {v!r}")
        return v

    # predicate grammar: OR < AND < NOT < primary
    def pred_or(self) -> Dict:
        args = [self.pred_and()]
        while self.at_kw("OR"):
            self.next()
            args.append(self.pred_and())
        return args[0] if len(args) == 1 else {"op": "or", "args": args}

    def pred_and(self) -> Dict:
        args = [self.pred_not()]
        while self.at_kw("AND"):
            self.next()
            args.append(self.pred_not())
        return args[0] if len(args) == 1 else {"op": "and", "args": args}

    def pred_not(self) -> Dict:
        if self.at_kw("NOT"):
            self.next()
            return {"op": "not", "arg": self.pred_not()}
        return self.primary()

    def primary(self) -> Dict:
        t, v = self.peek()
        if t == "(":
            self.next()
            e = self.pred_or()
            self.expect(")")
            return e
        if t != "ident":
            raise ValueError(f"SQL: expected a column name, got {v!r}")
        self.next()
        col = v
        t2, v2 = self.next()
        if t2 == "=":
            return {"op": "eq", "col": col, "value": self.expect("int")}
        if t2 == "ident" and v2.upper() == "IN":
            self.expect("(")
            vals = [self.expect("int")]
            while self.peek()[0] == ",":
                self.next()
                vals.append(self.expect("int"))
            self.expect(")")
            return {"op": "in", "col": col, "values": vals}
        if t2 == "ident" and v2.upper() == "BETWEEN":
            lo = self.expect("int")
            self.expect_kw("AND")
            hi = self.expect("int")
            return {"op": "range", "col": col, "lo": lo, "hi": hi}
        raise ValueError(f"SQL: expected =, IN or BETWEEN after "
                         f"{col!r}, got {v2!r}")

    def parse(self) -> Dict:
        self.expect_kw("SELECT")
        t, fn = self.next()
        if t != "ident" or fn.upper() not in ("COUNT", "SUM", "AVG",
                                              "MIN", "MAX"):
            raise ValueError(f"SQL: expected count(*)/sum(m)/avg(m)/min(m)"
                             f"/max(m), got {fn!r}")
        fn = fn.upper()
        self.expect("(")
        if fn == "COUNT":
            self.expect("*")
            sel: Dict = {"count": True}
        else:
            sel = {fn.lower(): self.expect("ident")}
        self.expect(")")
        self.expect_kw("FROM")
        self.expect("ident")  # table name: single-table engine, ignored
        out: Dict = {}
        if self.at_kw("WHERE"):
            self.next()
            out["where"] = self.pred_or()
        if self.at_kw("GROUP"):
            self.next()
            self.expect_kw("BY")
            by = [self.expect("ident")]
            while self.peek()[0] == ",":
                self.next()
                by.append(self.expect("ident"))
            if len(by) > 2:
                raise ValueError("SQL: GROUP BY takes at most two columns")
            sel["by"] = by
        if self.at_kw("LIMIT"):
            self.next()
            out["limit"] = self.expect("int")
        if self.peek()[0] != "end":
            raise ValueError(f"SQL: trailing input at {self.peek()[1]!r}")
        out["select"] = sel
        return out


def parse_sql(sql: str) -> Dict:
    """SQL-ish text -> the JSON statement object ``parse_statement``
    accepts (and ``POST /query`` executes).  See ``_SqlParser``."""
    if not isinstance(sql, str) or not sql.strip():
        raise ValueError("'sql' must be a non-empty statement string")
    return _SqlParser(sql).parse()


class QueryService:
    """Pooled, caching query service over one (re-buildable) index.

    Every query executes on a bounded worker pool; results are cached by the
    canonical structural key of the expression (plus backend and an index
    *generation* counter, so a rebuilt index can never serve stale rows).
    The result cache is size-aware: eviction honours both an entry cap and a
    byte budget over the cached EWAH payloads.  Sharded indexes execute
    shard-parallel on a forked process pool where the fork rule picks one,
    and otherwise one shard after another in the statement's own worker
    thread (the module docstring says why).

    Statements run their kernel path on ``device`` (``"cuda"`` by default;
    raises when CUDA is absent).  The result LRU budgets host results only.
    The executor's dense operands are not in it: each ``BitmapIndex``
    (each shard) keeps one dense copy on the device of every bitmap a
    kernel-path node has touched, in its ``dense_cache``, for the index's
    lifetime — at most the index's uncompressed words (each row padded to
    its power-of-two bucket) plus their flags (1,500 bitmaps of 2^22 rows:
    786 MB), with no knob to bound it; freed when a swap, reload or
    compaction retires the index.  Concurrent statements may both upload
    an operand they race on; the loser's copy is freed when its statement
    ends.
    """

    def __init__(self, index, backend: str = "auto",
                 max_rows: int = 10_000, pool_workers: int = 4,
                 cache_entries: int = 256,
                 cache_bytes: Optional[int] = DEFAULT_CACHE_BYTES,
                 cache_ttl: Optional[float] = None,
                 shard_processes: Optional[int] = None,
                 index_dir: Optional[str] = None,
                 fingerprints: Optional[List[tuple]] = None,
                 device: Device = "cuda"):
        self.device = resolve_device(device)
        self.index = index
        self.backend = backend
        self.max_rows = max_rows  # cap rows per response, count is exact
        self.cache = LRUCache(capacity=cache_entries, max_bytes=cache_bytes,
                              sizeof=payload_nbytes, ttl=cache_ttl,
                              classify=payload_kind)
        self._generation = 0
        self.pool_workers = max(int(pool_workers), 1)
        self._pool = ThreadPoolExecutor(max_workers=self.pool_workers,
                                        thread_name_prefix="query")
        # warm-start bookkeeping: the store directory this service was
        # opened from (if any) and the shard-file fingerprints, so
        # /admin/reload can swap exactly the shards whose files changed.
        # ``from_dir`` snapshots the fingerprints *before* loading — a shard
        # replaced between stat and load then just looks changed and gets
        # reloaded, never silently skipped.
        self.index_dir = index_dir
        if index_dir and fingerprints is None:
            fingerprints = index_store.shard_fingerprints(index_dir)
        self._fingerprints = fingerprints
        # shard fan-out pool: query workers wait on shard tasks, shard tasks
        # submit nothing, so the wait graph is acyclic (no pool deadlock).
        # ``shard_processes`` > 0 swaps in a fork-based ShardProcessPool so
        # CPU-bound EWAH shard work runs beyond the GIL (the pool's worker
        # initializer pins workers to the fork-safe EWAH backend); ``None``
        # (the default) picks the process pool automatically for sharded
        # indexes opened from a store directory on the CPU — there the
        # workers mmap-open the shard files themselves, so no fork-COW of
        # the parent heap is involved — and none everywhere else, on a CUDA
        # device too (forked workers never reach the card): a statement
        # then runs its shards in its own worker thread.  ``0`` forces
        # that.
        self.shard_processes = shard_processes if shard_processes is None \
            else int(shard_processes)
        self._shard_pool = self._make_shard_pool()
        # manifest fingerprint for the change watcher (None when not
        # store-backed); shard-file prints live in ``_fingerprints``
        self._manifest_print = self._manifest_fingerprint() \
            if index_dir else None
        self._reload_lock = threading.Lock()
        self._watcher: Optional[threading.Thread] = None
        self._watch_stop: Optional[threading.Event] = None
        self._watch_interval = 0.0
        # live-ingest bookkeeping: the mutable layer is attached lazily on
        # the first mutation (or eagerly via enable_live/from_dir); the
        # service closes the WAL only if it created the layer itself
        self._live_owned = False
        self._compactor = None

    @classmethod
    def from_dir(cls, index_dir: str, mmap: bool = True,
                 live: Optional[bool] = None, device: Device = "cuda",
                 **kwargs) -> "QueryService":
        """Warm start: open a saved sharded store directory and serve it.

        With ``mmap`` (default) open time is metadata-only — bitmap words
        stay on disk until queries touch them.  ``live=True`` attaches the
        WAL-backed mutable layer immediately; the default (``None``)
        attaches it when the store's write-ahead log exists on disk —
        replaying any mutations a crashed service never compacted.
        ``device`` is resolved before anything is opened."""
        device = resolve_device(device)
        # fingerprints BEFORE the load: a file replaced mid-open reads as
        # changed on the next /admin/reload instead of invisibly current
        prints = index_store.shard_fingerprints(index_dir)
        index = ShardedIndex.load(index_dir, mmap=mmap)
        svc = cls(index, index_dir=index_dir, fingerprints=prints,
                  device=device, **kwargs)
        if live is None:
            meta = index_store.manifest_meta(index_dir)
            wal_name = meta.get("wal") \
                or f"wal-{int(meta.get('epoch', 0)):05d}.log"
            live = os.path.exists(os.path.join(index_dir, wal_name))
        if live:
            svc.enable_live()
        return svc

    def _resolve_shard_processes(self) -> int:
        if self.shard_processes is not None:
            return self.shard_processes
        import multiprocessing
        if (self.device.type == "cpu"
                and self.index_dir is not None
                and isinstance(self.index, ShardedIndex)
                and "fork" in multiprocessing.get_all_start_methods()):
            return os.cpu_count() or 2
        return 0

    def _make_shard_pool(self):
        """The shard fan-out's process pool, or None: each statement then
        runs its shards one after another in its own worker thread."""
        procs = self._resolve_shard_processes()
        if procs > 0 and isinstance(self.index, ShardedIndex):
            from repro_torch.core.shard import ShardProcessPool
            # with a store directory, workers mmap-open the shard files
            # themselves instead of depending on fork-COW of the parent heap
            return ShardProcessPool(self.index, workers=procs,
                                    index_dir=self.index_dir)
        return None

    def _close_shard_pool(self) -> None:
        if self._shard_pool is not None:
            self._shard_pool.shutdown(wait=False)

    # -- lifecycle ---------------------------------------------------------
    def set_index(self, index) -> None:
        """Swap in a rebuilt index; the result cache is invalidated (the
        generation counter in every cache key retires old entries even if a
        racing query repopulates between the swap and the clear).

        Write order matters: the index is assigned *before* the generation
        bumps, and ``_snapshot`` reads the generation *before* the index, so
        no reader can ever pair the new generation with the old index — the
        combination that would let a stale result be cached under a live
        key.  The worst interleavings only produce orphan entries under a
        retired generation, which no future key matches."""
        self.index = index
        self._generation += 1
        self.cache.clear()
        self._close_shard_pool()
        self._shard_pool = self._make_shard_pool()

    def replace_shard(self, i: int, shard) -> None:
        """Swap one shard of a ``ShardedIndex`` in place.

        The full-result cache is retired via the generation counter (a
        cached result spans all shards), but the *other* shards' local
        result caches stay warm — re-running a cached query only recomputes
        the replaced slice.

        For a store-directory-backed service the shard file is rewritten
        (atomically) *first*: the directory is the source of truth — mmap
        process-pool workers re-open shards from it after the generation
        bump, and a restart must come back with the same data the live
        service answered with."""
        idx = self.index
        if not isinstance(idx, ShardedIndex):
            raise TypeError("replace_shard needs a ShardedIndex")
        if self.index_dir:
            idx.replace_shard_file(self.index_dir, i, shard)
            self._fingerprints = index_store.shard_fingerprints(
                self.index_dir)
        else:
            idx.replace_shard(i, shard)
        self._generation += 1
        self.cache.clear()

    def reload_from_dir(self, mmap: bool = True) -> Dict:
        """Re-stat the store directory and swap in shards whose files
        changed on disk (atomically replaced by an out-of-band reindex).

        Unchanged shards keep their objects *and* their warm shard-local
        result caches; a shard-count change falls back to a full
        ``set_index``.  Returns a summary for the ``/admin/reload`` caller.
        Serialized against the background watcher by ``_reload_lock``.
        """
        if not self.index_dir:
            raise ValueError("service was not opened from an index dir")
        with self._reload_lock:
            return self._reload_locked(mmap)

    def _reload_locked(self, mmap: bool = True) -> Dict:
        from repro_torch.core.ingest import LiveIndex
        if isinstance(self.index, LiveIndex):
            # the live layer IS the source of truth here (it persisted the
            # store itself at its last compaction) — just resync the prints
            self._fingerprints = index_store.shard_fingerprints(
                self.index_dir)
            return {"reloaded": [], "full": False, "live": True,
                    "n_shards": self.index.n_shards}
        new_prints = index_store.shard_fingerprints(self.index_dir)
        old_prints = self._fingerprints or []
        if (not isinstance(self.index, ShardedIndex)
                or len(new_prints) != len(old_prints)):
            self.set_index(ShardedIndex.load(self.index_dir, mmap=mmap))
            self._fingerprints = new_prints
            return {"reloaded": list(range(len(new_prints))), "full": True,
                    "n_shards": len(new_prints)}
        changed = [i for i, (a, b) in enumerate(zip(old_prints, new_prints))
                   if a != b]
        if changed and len(changed) == len(new_prints):
            # every shard file changed (e.g. a layout optimize rewrote the
            # whole store under new oNNNNN- names): no shard-local cache
            # would stay warm anyway, and the replacement encoders may
            # legitimately differ from the retiring ones (frequency remaps)
            # — which the per-shard swap validation rejects mid-swap.  Swap
            # the whole index in one generation bump; in-flight queries
            # finish on their snapshot of the old index.
            self.set_index(ShardedIndex.load(self.index_dir, mmap=mmap))
            self._fingerprints = new_prints
            return {"reloaded": changed, "full": True,
                    "n_shards": len(new_prints)}
        for i in changed:
            shard = index_store.load(
                os.path.join(self.index_dir, new_prints[i][0]), mmap=mmap)
            # in-memory swap only: the directory already holds this shard
            self.index.replace_shard(i, shard)
            self._generation += 1
            self.cache.clear()
        self._fingerprints = new_prints
        return {"reloaded": changed, "full": False,
                "n_shards": len(new_prints)}

    # -- change watcher (auto /admin/reload) --------------------------------
    def _manifest_fingerprint(self):
        try:
            st = os.stat(os.path.join(self.index_dir,
                                      index_store.MANIFEST_NAME))
        except OSError:
            return None
        return (st.st_mtime_ns, st.st_size)

    def check_reload(self) -> Optional[Dict]:
        """One watcher tick: stat the manifest and shard files, reload iff
        anything changed since the last look.  Returns the reload summary,
        or ``None`` when the directory is current (the common, cheap case —
        a handful of ``stat`` calls, no file is opened).

        The fingerprints are snapshotted *before* the reload: a rewrite
        racing the reload just looks changed again on the next tick, never
        silently current.
        """
        if not self.index_dir:
            raise ValueError("service was not opened from an index dir")
        mf = self._manifest_fingerprint()
        try:
            prints = index_store.shard_fingerprints(self.index_dir)
        except index_store.StoreError:
            return None  # mid-rewrite; the next tick sees the finished state
        if mf == self._manifest_print and prints == (self._fingerprints or []):
            return None
        out = self.reload_from_dir()
        self._manifest_print = mf
        return out

    def start_watcher(self, interval: float = 2.0) -> threading.Thread:
        """Poll the store directory every ``interval`` seconds and pick up
        atomically replaced shard files / manifests without an explicit
        ``/admin/reload`` (idempotent; the thread is a daemon)."""
        if not self.index_dir:
            raise ValueError("service was not opened from an index dir")
        if self._watcher is not None:
            return self._watcher
        self._watch_interval = float(interval)
        self._watch_stop = threading.Event()
        t = threading.Thread(target=self._watch_loop, daemon=True,
                             name="reload-watch")
        self._watcher = t
        t.start()
        return t

    def _watch_loop(self) -> None:
        while not self._watch_stop.wait(self._watch_interval):
            try:
                self.check_reload()
            except Exception:
                pass  # transient (mid-rewrite stat races); keep watching

    def stop_watcher(self) -> None:
        if self._watcher is None:
            return
        self._watch_stop.set()
        self._watcher.join(timeout=5)
        self._watcher = None
        self._watch_stop = None

    def invalidate_cache(self) -> None:
        self.cache.clear()

    def close(self) -> None:
        self.stop_watcher()
        if self._compactor is not None:
            self._compactor.stop()
            self._compactor = None
        if self._live_owned:
            self.index.close()  # flush + close the WAL we opened
        self._pool.shutdown(wait=False)
        self._close_shard_pool()

    # -- live ingest ---------------------------------------------------------
    def enable_live(self):
        """Wrap the served index in the WAL-backed mutable layer
        (``repro_torch.core.ingest.LiveIndex``) so ``/ingest`` and ``/delete``
        can mutate it.  Store-backed services get a durable WAL in the
        store directory (replayed here if one already exists); purely
        in-memory services get an in-memory delta with no log."""
        from repro_torch.core.ingest import LiveIndex
        if isinstance(self.index, LiveIndex):
            return self.index
        self.set_index(LiveIndex(self.index, dir_path=self.index_dir,
                                 device=self.device))
        self._live_owned = True
        return self.index

    def ingest(self, rows, measures=None) -> Dict:
        """Durably append rows (with optional aligned measure values);
        queries see them immediately (base ⊔ delta)."""
        if rows is None:
            raise ValueError('ingest needs {"rows": [[...], ...]}')
        live = self.enable_live()
        ms = None
        if measures:
            if not isinstance(measures, dict):
                raise ValueError('"measures" must map name -> value list')
            ms = {str(k): np.asarray(v) for k, v in measures.items()}
        appended = live.append(np.asarray(rows), measures=ms)
        return {"ok": True, "appended": appended, "n_rows": live.n_rows,
                "delta_rows": live.delta.n_rows}

    def delete(self, where) -> Dict:
        """Durably delete rows matching ``where`` (compressed tombstones)."""
        if where is None:
            raise ValueError('delete needs {"where": <expr>}')
        live = self.enable_live()
        e = parse_expr(where) if isinstance(where, dict) else where
        removed = live.delete(e)
        return {"ok": True, "removed": removed, "n_rows": live.n_rows,
                "tombstone_rows": live.tombstone_rows}

    def compact(self) -> Dict:
        """Fold pending mutations into a freshly sorted base now."""
        live = self.enable_live()
        info = live.compact()
        self._after_compact(info)
        return {"ok": True, **info}

    def _after_compact(self, info=None) -> None:
        # compaction rewrote the store (new epoch-prefixed shard files +
        # manifest): refresh the fingerprints so /admin/reload compares
        # against what the live layer just persisted
        if self.index_dir:
            self._fingerprints = index_store.shard_fingerprints(
                self.index_dir)

    def start_compactor(self, interval: float = 30.0,
                        min_pending_rows: int = 1):
        """Start the background compaction thread (idempotent)."""
        from repro_torch.core.ingest import Compactor
        live = self.enable_live()
        if self._compactor is None:
            self._compactor = Compactor(
                live, interval=interval, min_pending_rows=min_pending_rows,
                on_compact=self._after_compact).start()
        return self._compactor

    def optimize(self, col_order="auto", remap: bool = True) -> Dict:
        """Rewrite the backing store into the layout advisor's physical
        layout (column sort order + frequency remaps), then swap the
        rewritten shards in without dropping the service.

        The rewrite itself is ``Dataset.optimize`` on the store directory:
        new ``oNNNNN-`` prefixed shard files land first, the manifest
        rewrite is the atomic cutover, and the old files are unlinked only
        after it (mmaps held by in-flight queries keep the old inodes
        alive).  Because every new shard file has a new name, the normal
        ``/admin/reload`` fingerprint diff then sees every shard as changed
        and swaps the rewritten index in behind one generation bump —
        queries keep answering throughout (in-flight ones finish on their
        snapshot of the old index).  Live services fold pending mutations
        in with a compaction first, then get a fresh live layer over the
        optimized base (the WAL is empty at that point, so nothing
        replays)."""
        if not self.index_dir:
            raise ValueError("optimize needs a store directory "
                             "(serve with --index-dir / --save-index)")
        from repro_torch.core.dataset import Dataset
        from repro_torch.core.ingest import LiveIndex
        with self._reload_lock:
            live = isinstance(self.index, LiveIndex)
            if live and self.index.pending_rows:
                # the optimize rewrite reads the *store*; fold the delta +
                # tombstones into it first so no live row is left behind
                self._after_compact(self.index.compact())
            ds = Dataset.open(self.index_dir, live=False,
                              device=self.device)
            out = ds.optimize(col_order=col_order, remap=remap)
            if live:
                # the old live layer's base mmaps now reference unlinked
                # files; rebuild it over the optimized store (its recipe and
                # layout come from the fresh manifest).  In-flight queries
                # finish against their snapshot of the old layer.
                old = self.index
                self.set_index(LiveIndex(ShardedIndex.load(self.index_dir),
                                         dir_path=self.index_dir,
                                         device=self.device))
                old.close()
                out["reloaded"] = list(range(self.index.n_shards))
                out["live"] = True
            else:
                rl = self._reload_locked()
                out["reloaded"] = list(range(rl["n_shards"])) \
                    if rl.get("full") else rl["reloaded"]
            self._fingerprints = index_store.shard_fingerprints(
                self.index_dir)
            self._manifest_print = self._manifest_fingerprint()
            return out

    # -- execution ---------------------------------------------------------
    def _submit(self, fn, *args):
        """Run ``fn(*args)`` on the query pool, under the caller's span."""
        return self._pool.submit(_trace.carry(fn), *args)

    def _snapshot(self):
        """(generation, index) pair that is safe to execute and cache under
        (generation read first; see ``set_index`` for the ordering proof)."""
        gen = self._generation
        return gen, self.index

    def _execute_cached(self, e: Expr, op_cache: Optional[Dict],
                        snapshot=None):
        gen, idx = snapshot if snapshot is not None else self._snapshot()
        # a live index's own mutation generation joins the key (read before
        # executing, like ``gen``): every append/delete/compaction retires
        # all cached results without a cache clear
        key = (gen, getattr(idx, "generation", None), self.backend,
               canonical_key(e))
        bm = self.cache.get(key)
        if bm is not None:
            return bm, True
        pool = None if isinstance(idx, BitmapIndex) else self._shard_pool
        bm = execute(idx, e, backend=self.backend, cache=op_cache, pool=pool,
                     device=self.device)
        self.cache.put(key, bm)
        return bm, False

    def _result(self, bm, cached: bool) -> Dict:
        rows = bm.set_bits()  # pad bits already masked, so len == popcount
        return {
            "count": len(rows),
            "rows": rows[: self.max_rows].tolist(),
            "truncated": bool(len(rows) > self.max_rows),
            "result_words": bm.size_words,
            "cached": cached,
        }

    def _query_one(self, e: Expr, explain_plan: bool = False,
                   op_cache: Optional[Dict] = None, snapshot=None) -> Dict:
        bm, cached = self._execute_cached(e, op_cache, snapshot)
        out = self._result(bm, cached)
        if explain_plan:
            out["plan"] = self.explain(e)
        return out

    def explain(self, e: Expr) -> str:
        from repro_torch.core.ingest import LiveIndex
        idx = self.index
        if isinstance(idx, LiveIndex):
            idx = idx.base  # the delta layer plans the same tree
        if isinstance(idx, ShardedIndex):
            head = f"per-shard plans x{idx.n_shards}; shard 0:\n"
            return head + explain(plan(idx.shards[0], e))
        return explain(plan(idx, e))

    def query(self, expr, explain_plan: bool = False) -> Dict:
        e = parse_expr(expr) if isinstance(expr, dict) else expr
        return self._submit(self._query_one, e, explain_plan).result()

    def query_batch(self, exprs: Sequence) -> List[Dict]:
        es = [parse_expr(e) if isinstance(e, dict) else e for e in exprs]
        # the whole batch executes against one (generation, index) snapshot,
        # so a mid-batch set_index can't mix bitmaps of two indexes through
        # the shared operand cache; uncached queries share loaded operands
        # via the Executor's dict (benign races — worst case a bitmap loads
        # twice), with per-shard sub-caches on the sharded path
        snapshot = self._snapshot()
        op_cache: Dict = {}
        futs = [self._submit(self._query_one, e, False, op_cache, snapshot)
                for e in es]
        return [f.result() for f in futs]

    # -- aggregation statements (compressed domain) -------------------------
    def _agg_cached(self, kind: str, col, e: Optional[Expr], compute):
        """Cache wrapper shared by the aggregate statements: keyed by the
        statement kind + resolved column + the filter's canonical key (and
        the index generation, like row results).

        The column resolves against the *snapshotted* index — resolving
        against ``self.index`` outside the snapshot would let a concurrent
        ``set_index`` cache another column's counts under a live key.
        ``col`` may also be a list of grouping columns (group_agg)."""
        gen, idx = self._snapshot()
        if isinstance(col, (list, tuple)):
            c = tuple(idx.resolve_column(x) for x in col)
        else:
            c = idx.resolve_column(col) if col is not None else None
        key = (gen, getattr(idx, "generation", None), self.backend, kind, c,
               canonical_key(e) if e is not None else None)
        val = self.cache.get(key)
        if val is not None:
            return val, True
        pool = None if isinstance(idx, BitmapIndex) else self._shard_pool
        val = compute(idx, pool, c)
        self.cache.put(key, val)
        return val, False

    def _count_one(self, e: Optional[Expr]) -> Dict:
        cnt, cached = self._agg_cached(
            "count", None, e,
            lambda idx, pool, _c: execute_count(idx, e, backend=self.backend,
                                                pool=pool, device=self.device))
        return {"select": "count", "count": int(cnt), "cached": cached}

    def _group_count_one(self, col, e: Optional[Expr]) -> Dict:
        counts, cached = self._agg_cached(
            "group_count", col, e,
            lambda idx, pool, c: execute_group_count(
                idx, c, e, backend=self.backend, pool=pool,
                device=self.device))
        return {"select": "group_count", "col": col,
                "counts": [int(x) for x in counts], "cached": cached}

    def _agg_one(self, op: str, measure: str, e: Optional[Expr]) -> Dict:
        """Scalar sum/avg/min/max over the measure sidecar, evaluated by
        slicing mmap'd measure arrays with the filter's intervals."""
        agg, cached = self._agg_cached(
            f"agg:{measure}", None, e,
            lambda idx, pool, _c: execute_agg(
                idx, measure, e, backend=self.backend, pool=pool,
                device=self.device))
        val = measures_mod.finalize_scalar(op, agg)
        return {"select": op, "measure": measure, "value": val,
                "count": int(agg[1]), "cached": cached}

    def _group_agg_one(self, op: str, measure: Optional[str], by,
                       e: Optional[Expr]) -> Dict:
        """Grouped aggregate over 1-2 columns; ``measure=None`` is the
        multi-column count.  The value matrix is row-major nested lists
        (shape ``[card(a)]`` or ``[card(a), card(b)]``); empty avg/min/max
        cells serialize as null."""
        agg, cached = self._agg_cached(
            f"gagg:{op}:{measure}", list(by), e,
            lambda idx, pool, cs: execute_group_agg(
                idx, measure, list(cs), e, backend=self.backend, pool=pool,
                device=self.device))
        shape = list(agg["shape"])

        def nest(flat):
            a = np.asarray(flat).reshape(shape)
            return a.tolist()

        out = {"select": "group_agg", "op": op, "measure": measure,
               "by": list(by), "shape": shape,
               "counts": nest(agg["counts"]), "cached": cached}
        if op != "count":
            out["values"] = nan_to_none(
                nest(measures_mod.finalize_group(op, agg)))
        return out

    def _top_k_one(self, col, k: int, e: Optional[Expr],
                   measure: Optional[str] = None) -> Dict:
        if measure is None:
            out = self._group_count_one(col, e)
            top = top_k_from_counts(np.asarray(out["counts"]), k)
            return {"select": "top_k", "col": col, "k": int(k),
                    "measure": None, "top": [[v, c] for v, c in top],
                    "cached": out["cached"]}

        # rank by SUM(measure): sharded indexes run the shard-pruned
        # two-phase protocol; monolithic/live fall back to the full
        # grouped sum (one vector — nothing to prune)
        def compute(idx, pool, c):
            if isinstance(idx, ShardedIndex):
                return idx.top_k(c, k, e, measure=measure,
                                 backend=self.backend, pool=pool,
                                 device=self.device)
            agg = execute_group_agg(idx, measure, [c], e,
                                    backend=self.backend, pool=pool,
                                    device=self.device)
            vals = measures_mod.finalize_group("sum", agg)
            return top_k_from_values(np.asarray(vals),
                                     np.asarray(agg["counts"]), k)

        top, cached = self._agg_cached(
            f"topk:{measure}:{int(k)}", col, e, compute)
        return {"select": "top_k", "col": col, "k": int(k),
                "measure": measure,
                "top": [[int(r), (int(v) if isinstance(v, (int, np.integer))
                                  else float(v))] for r, v in top],
                "cached": cached}

    def count(self, where=None) -> Dict:
        e = parse_expr(where) if isinstance(where, dict) else where
        return self._submit(self._count_one, e).result()

    def group_count(self, col, where=None) -> Dict:
        e = parse_expr(where) if isinstance(where, dict) else where
        return self._submit(self._group_count_one, col, e).result()

    def top_k(self, col, k: int, where=None, measure=None) -> Dict:
        e = parse_expr(where) if isinstance(where, dict) else where
        return self._submit(self._top_k_one, col, k, e, measure).result()

    def agg(self, op: str, measure: str, where=None) -> Dict:
        """Scalar sum/avg/min/max of a measure under an optional filter."""
        e = parse_expr(where) if isinstance(where, dict) else where
        return self._submit(self._agg_one, op, measure, e).result()

    def group_agg(self, op: str, measure: Optional[str], by,
                  where=None) -> Dict:
        """Grouped sum/avg/min/max/count over 1-2 columns."""
        e = parse_expr(where) if isinstance(where, dict) else where
        return self._submit(self._group_agg_one, op, measure, list(by),
                            e).result()

    def sql(self, text: str) -> Dict:
        """Execute one SQL-ish statement (see ``parse_sql``)."""
        return self.statement(parse_sql(text))

    def statement(self, obj: Dict) -> Dict:
        """Execute one ``{"select": ..., "where": ...}`` wire statement.
        Its server time is added to the counters of its kind
        (``statement_kind``), which ``stats()`` reports as
        ``statements``."""
        st = parse_statement(obj)
        kind, e = st["kind"], st["where"]
        if kind == "count":
            fn, args = self._count_one, (e,)
        elif kind == "group_count":
            fn, args = self._group_count_one, (st["col"], e)
        elif kind == "agg":
            fn, args = self._agg_one, (st["op"], st["measure"], e)
        elif kind == "group_agg":
            fn, args = self._group_agg_one, (st["op"], st["measure"],
                                             st["by"], e)
        else:
            fn, args = self._top_k_one, (st["col"], st["k"], e,
                                         st["measure"])
        name = statement_kind(obj)
        t = time.perf_counter()
        with _trace.span("service.statement", kind=name):
            out = self._submit(fn, *args).result()
        _trace.count(f"{_STATEMENTS}{name}/n")
        _trace.count(f"{_STATEMENTS}{name}/seconds",
                     time.perf_counter() - t)
        return out

    def stats(self) -> Dict:
        from repro_torch.core.ingest import LiveIndex
        idx = self.index
        n_cols = (len(idx.columns) if isinstance(idx, BitmapIndex)
                  else idx.n_columns)
        out = {
            "n_rows": idx.n_rows,
            "n_columns": n_cols,
            "n_bitmaps": idx.n_bitmaps,
            "n_partitions": idx.n_partitions,
            "size_words": idx.size_words,
            "column_names": idx.column_names,
            "cards": [idx.card(c) for c in range(n_cols)],
            "pool_workers": self.pool_workers,
            "cache": self.cache.stats(),
            "measures": sorted(getattr(idx, "measure_names", []) or []),
        }
        sharded = idx
        if isinstance(idx, LiveIndex):
            out["live"] = idx.stats()
            if self._compactor is not None:
                out["compactor"] = self._compactor.stats()
            sharded = idx.base
        if isinstance(sharded, ShardedIndex):
            out["n_shards"] = sharded.n_shards
            out["shard_rows"] = np.diff(sharded.offsets).tolist()
            out["shard_caches"] = sharded.cache_stats()
        # physical-layout provenance: the advisor's decision (column order,
        # frequency remaps, stats snapshot) as persisted in the manifest —
        # the live layer's recipe when serving live (it survives relayout
        # compactions), the manifest otherwise; None for pre-advisor stores
        if isinstance(idx, LiveIndex):
            out["layout"] = idx.recipe.get("layout")
        elif self.index_dir:
            out["layout"] = index_store.manifest_meta(
                self.index_dir).get("layout")
        else:
            out["layout"] = None
        counts = _trace.counter_values()
        out["counters"] = {k: v for k, v in sorted(counts.items())
                           if not k.startswith(_STATEMENTS)}
        out["statements"] = statements = {}
        for k, v in sorted(counts.items()):
            if k.startswith(_STATEMENTS):
                name, field = k[len(_STATEMENTS):].rsplit("/", 1)
                statements.setdefault(name, {})[field] = v
        m = cost_model.get_default()
        th = m.dense_threshold
        out["cost_model"] = {
            # inf (= "EWAH always wins here") is not JSON; null carries it
            "dense_threshold": float(th) if np.isfinite(th) else None,
            "calibrated": bool(m.calibrated),
            "source": m.source,
            "machine": m.machine,
            "machine_match": bool(m.machine_match),
            "array_cutoff": int(m.array_cutoff),
        }
        return out

    def scrub(self) -> Dict:
        """Full-CRC audit of the backing store directory.

        Reads every TOC segment through a fresh read-only memmap, so it is
        safe to run against files this service is concurrently serving
        mmap'd — no lock, no cache invalidation, no interference.  Corrupt
        segments are reported per shard, never raised (``ok`` flags the
        aggregate verdict)."""
        if not self.index_dir:
            raise ValueError("scrub needs a store directory "
                             "(serve with --index-dir / --save-index)")
        return index_store.scrub_sharded(self.index_dir)


class _HTTPError(Exception):
    """Request rejected before (or instead of) reaching the service.

    Carries an HTTP status plus a stable machine-readable ``code`` so
    clients can branch on the *kind* of rejection without parsing prose:
    ``bad_json`` (unparseable body), ``bad_request`` (parseable but
    invalid — wrong shape, unknown statement kind, bad expression),
    ``too_large`` (body over the ``--max-body-bytes`` cap → 413),
    ``not_found`` (unknown route)."""

    def __init__(self, status: int, code: str, msg):
        super().__init__(str(msg))
        self.status = int(status)
        self.code = code


class _Handler(BaseHTTPRequestHandler):
    service: QueryService  # set by make_server
    max_body_bytes: Optional[int] = None  # set by make_server

    def _send(self, code: int, payload: Dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _fail(self, exc: _HTTPError):
        self._send(exc.status, {"error": str(exc), "code": exc.code})

    def do_GET(self):
        if self.path == "/healthz":
            self._send(200, {"ok": True})
        elif self.path == "/stats":
            self._send(200, self.service.stats())
        else:
            self._fail(_HTTPError(404, "not_found",
                                  f"unknown path {self.path}"))

    def _body(self) -> Dict:
        """Read + parse the request body under the hardening rules: the
        byte cap is enforced on the declared length *before reading*, the
        JSON must parse, and the top level must be an object."""
        try:
            n = int(self.headers.get("Content-Length", 0) or 0)
        except (TypeError, ValueError):
            raise _HTTPError(400, "bad_request", "invalid Content-Length")
        cap = self.max_body_bytes
        if cap is not None and n > cap:
            raise _HTTPError(413, "too_large",
                             f"request body is {n} bytes; this server "
                             f"accepts at most {cap}")
        try:
            obj = json.loads(self.rfile.read(n) or b"{}")
        except json.JSONDecodeError as exc:
            raise _HTTPError(400, "bad_json", f"malformed JSON body: {exc}")
        if not isinstance(obj, dict):
            raise _HTTPError(400, "bad_request",
                             "body must be a JSON object, got "
                             f"{type(obj).__name__}")
        return obj

    def do_POST(self):
        try:
            with _trace.span("http.request", path=self.path):
                self._post()
        except _HTTPError as exc:
            self._fail(exc)
        except (ValueError, KeyError, TypeError) as exc:
            # service-level rejection (unknown statement kind, bad column,
            # malformed expression...).  KeyError's str() wraps its message
            # in quotes; unwrap it.
            msg = exc.args[0] if exc.args else str(exc)
            self._fail(_HTTPError(400, "bad_request", msg))

    def _post(self):
        if self.path == "/admin/invalidate":
            self.service.invalidate_cache()
            self._send(200, {"ok": True})
            return
        if self.path == "/admin/reload":
            try:
                out = self.service.reload_from_dir()
            except index_store.StoreError as exc:
                raise _HTTPError(400, "bad_request", exc)
            out["ok"] = True
            self._send(200, out)
            return
        if self.path == "/admin/scrub":
            # corruption is *reported*, not fatal: a store with bad
            # segments still answers 200 with ok=false + the per-shard list
            self._send(200, self.service.scrub())
            return
        if self.path == "/ingest":
            req = self._body()
            self._send(200, self.service.ingest(req.get("rows"),
                                                req.get("measures")))
            return
        if self.path == "/delete":
            self._send(200, self.service.delete(self._body().get("where")))
            return
        if self.path == "/admin/compact":
            self._send(200, self.service.compact())
            return
        if self.path == "/admin/optimize":
            req = self._body()
            out = self.service.optimize(
                col_order=req.get("col_order", "auto"),
                remap=bool(req.get("remap", True)))
            out["ok"] = True
            self._send(200, out)
            return
        if self.path != "/query":
            raise _HTTPError(404, "not_found", f"unknown path {self.path}")
        req = self._body()
        if "sql" in req:
            self._send(200, self.service.statement(parse_sql(req["sql"])))
        elif "select" in req:
            self._send(200, self.service.statement(req))
        elif "queries" in req:
            if not isinstance(req["queries"], list):
                raise _HTTPError(400, "bad_request",
                                 "'queries' must be a list of expressions")
            self._send(200, {"results":
                             self.service.query_batch(req["queries"])})
        elif "query" in req:
            self._send(200, self.service.query(
                req["query"], explain_plan=bool(req.get("explain"))))
        else:
            raise _HTTPError(400, "bad_request",
                             "body needs 'query', 'queries' or 'select'")

    def log_message(self, *args):  # quiet by default
        pass


class _Server(ThreadingHTTPServer):
    # the listen backlog: socketserver's default of 5 resets connections
    # once more clients than that connect at the same instant
    request_queue_size = 128


def make_server(service: QueryService, host: str = "127.0.0.1",
                port: int = 8321,
                max_body_bytes: Optional[int] = None) -> ThreadingHTTPServer:
    """HTTP front end for a ``QueryService`` — or anything statement-
    compatible with one (``repro_torch.distributed.cluster.ClusterService``
    mounts here unchanged).  ``max_body_bytes`` caps accepted request
    bodies (413 + code ``too_large`` beyond it); coordinator and worker
    endpoints share one cap so an oversized statement is rejected at
    whichever tier sees it first."""
    handler = type("BoundHandler", (_Handler,),
                   {"service": service, "max_body_bytes": max_body_bytes})
    return _Server((host, port), handler)


def serve_in_thread(service: QueryService, host: str = "127.0.0.1",
                    port: int = 0, max_body_bytes: Optional[int] = None):
    """Start the server on a daemon thread; returns (server, port)."""
    srv = make_server(service, host, port, max_body_bytes=max_body_bytes)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, srv.server_address[1]


def _demo_index(n_rows: int, shards: int = 0,
                rng: Optional[np.random.Generator] = None):
    rng = rng or np.random.default_rng(0)
    table = synth.census_like_table(n_rows, rng)
    ranked, _ = synth.factorize(table)
    ranked = ranked[lex_sort(ranked)]
    names = ["region", "day", "user"]
    if shards > 1:
        shard_rows = max(-(-n_rows // shards) // 32 * 32, 32)
        return ShardedIndex.build(ranked, shard_rows=shard_rows, k=2,
                                  column_names=names)
    return BitmapIndex.build(ranked, k=2, column_names=names)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8321)
    ap.add_argument("--rows", type=int, default=50_000)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "ewah", "kernel"])
    ap.add_argument("--device", default="cuda",
                    help="where the kernel path runs: cuda (default; "
                         "raises without a card) or cpu")
    ap.add_argument("--shards", type=int, default=0,
                    help="split the demo index into this many row shards")
    ap.add_argument("--workers", type=int, default=4,
                    help="query worker pool size")
    ap.add_argument("--cache", type=int, default=256,
                    help="LRU result-cache entries (0 disables)")
    ap.add_argument("--cache-mb", type=float, default=DEFAULT_CACHE_BYTES / 2**20,
                    help="result-cache byte budget in MiB (total EWAH bytes)")
    ap.add_argument("--cache-ttl", type=float, default=0,
                    help="result-cache entry TTL in seconds (0 = no expiry)")
    ap.add_argument("--shard-procs", type=int, default=None,
                    help="shard-parallel worker *processes* (0 = thread "
                         "pool; default: processes when serving a store "
                         "directory on --device cpu, threads otherwise)")
    ap.add_argument("--watch-interval", type=float, default=0,
                    help="poll the store directory every N seconds and "
                         "auto-reload changed shard files (0 = off; "
                         "needs --index-dir)")
    ap.add_argument("--index-dir", default=None,
                    help="warm start: serve a saved index store directory "
                         "(mmap'd; skips the demo build entirely)")
    ap.add_argument("--save-index", default=None, metavar="DIR",
                    help="build the demo index, persist it to DIR, then "
                         "serve from the saved (mmap'd) files")
    ap.add_argument("--live", action="store_true",
                    help="enable /ingest + /delete (WAL-backed mutable "
                         "layer) and start the background compactor")
    ap.add_argument("--compact-interval", type=float, default=30.0,
                    help="background compaction check period in seconds")
    ap.add_argument("--compact-rows", type=int, default=10_000,
                    help="pending mutation rows that trigger a compaction")
    ap.add_argument("--max-body-bytes", type=int, default=None,
                    help="largest accepted HTTP request body in bytes "
                         "(413 + code 'too_large' beyond it; default "
                         "unlimited)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    kw = dict(backend=args.backend, pool_workers=args.workers,
              cache_entries=args.cache,
              cache_bytes=int(args.cache_mb * 2**20),
              cache_ttl=args.cache_ttl or None,
              shard_processes=args.shard_procs, device=device)
    if args.index_dir:
        t0 = time.perf_counter()
        service = QueryService.from_dir(args.index_dir, **kw)
        origin = (f"warm start {args.index_dir} "
                  f"({time.perf_counter() - t0:.3f}s open)")
    else:
        index = _demo_index(args.rows, args.shards)
        if args.save_index:
            if not isinstance(index, ShardedIndex):
                index = ShardedIndex([index])
            index.save(args.save_index)
            service = QueryService.from_dir(args.save_index, **kw)
            origin = f"built + saved to {args.save_index}, serving mmap'd"
        else:
            service = QueryService(index, **kw)
            origin = f"built {args.rows} rows in memory"
    if args.live:
        service.enable_live()
        service.start_compactor(interval=args.compact_interval,
                                min_pending_rows=args.compact_rows)
    if args.watch_interval and service.index_dir:
        service.start_watcher(interval=args.watch_interval)
    idx = service.index
    srv = make_server(service, args.host, args.port,
                      max_body_bytes=args.max_body_bytes)
    print(f"[query_api] {origin}; serving {idx.n_rows} rows on "
          f"http://{args.host}:{srv.server_address[1]} "
          f"(backend={args.backend}, device={device}, "
          f"shards={getattr(idx, 'n_shards', 1)}, "
          f"workers={args.workers}, cache={args.cache}, "
          f"ttl={args.cache_ttl or 'off'})", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
