"""Fault-tolerant scatter/gather coordinator over RPC shard workers.

``ClusterService`` is the cluster-sized sibling of
``repro_torch.serve.query_api.QueryService``: the same statements (count /
group-by / top-k / sum/avg/min/max / grouped measure aggregates / row
queries, plus the SQL-ish front door), the same wire expressions, the same
HTTP front end (``make_server`` accepts either service) — but execution
fans out over TCP to ``repro_torch.serve.worker_api`` workers, each mmap-serving
a subset of the shard store files.  Aggregates are the ideal first
distributed workload: a shard's contribution is an integer, a small count
vector, or a ``(sum, count, min, max)`` measure partial (the same
per-shard partials ``ShardedIndex`` already merges in-process), so
scatter/gather ships a few hundred bytes per shard, never a decompressed
bitmap — grouped measure aggregates ship one flat matrix per shard.

Every fan-out runs under a **robustness policy** (``Policy``):

* **per-task deadline** — a shard task that cannot complete in
  ``deadline_s`` is abandoned; the query degrades rather than hangs.
* **bounded retries with exponential backoff + jitter** — each retry round
  rotates to the next replica of the shard, so a sick worker is routed
  around, and jitter decorrelates retry storms.
* **hedged requests** — if the primary replica has not answered within an
  adaptive latency percentile (``hedge_pctl`` over a rolling window,
  ``hedge_after_s`` until the window fills), the same task is speculatively
  sent to a backup replica and the first answer wins.  Tail latency from a
  slow worker costs one duplicate RPC instead of a deadline.
* **health probes + eviction + re-placement** — a monitor probes workers;
  ``fail_threshold`` consecutive failures evict a worker, and its shards
  are re-assigned to healthy peers (an ``assign`` op — the peer mmap-opens
  the shard file from the shared store directory, a metadata-only open).
  A killed worker's shards are re-served by replicas *without restarting
  the coordinator*; a recovered worker is re-admitted by the next probe.
* **graceful degradation** — a query whose shards are all unreachable
  returns a structured partial result: ``exact: false``,
  ``missing_shards``, and ``covered_rows`` (how many fact rows the answer
  actually covers).  Exactness is always flagged; partial results are
  never cached.

Responses travel the CRC-framed wire protocol (``repro_torch.distributed.wire``),
so a torn or corrupt response is *detected, never half-applied* — it counts
as a replica failure and the robustness policy takes over.  The frames are
the reference package's, byte for byte, so this coordinator drives its
workers and the other way round.

The coordinator does host work only — metadata, merges, the result LRU —
and takes no device: the workers run the kernel path on theirs
(``repro_torch.serve.worker_api``).

Shard→worker **placement** is k-way replicated round-robin
(``round_robin_placement``), with optional extra replicas for hot shards.
Rolling shard replacement rides the workers' fingerprint-diff ``reload``
op (the ``/admin/reload`` discipline, per worker): only shards whose store
files changed are reopened, caches on unchanged shards stay warm.

Run a coordinator over already-running workers::

    PYTHONPATH=src python -m repro_torch.distributed.cluster \
        --index-dir /tmp/idx --workers 127.0.0.1:9101,127.0.0.1:9102 \
        --port 8321

(``repro_torch.launch.cluster`` spins up the whole topology in one command.)
"""
from __future__ import annotations

import argparse
import os
import queue
import random
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import store as index_store
from repro_torch.core.ewah import EWAH
from repro_torch.core.expr import Expr, canonical_key, to_wire
from repro_torch.core.lru import LRUCache, payload_kind, payload_nbytes
from repro_torch.core.shard import ShardedIndex
from . import wire


@dataclass
class Policy:
    """Robustness knobs for every coordinator→worker fan-out."""
    deadline_s: float = 2.0        # per shard-task deadline
    retries: int = 2               # replica retry rounds after the first
    backoff_s: float = 0.05        # first backoff; doubles per round
    backoff_max_s: float = 0.5
    jitter: float = 0.5            # backoff *= 1 + U(0, jitter)
    hedge_after_s: float = 0.25    # hedge delay until the window fills
    hedge_pctl: float = 95.0       # then: this percentile of observed RTTs
    hedge_min_s: float = 0.005
    probe_interval_s: float = 1.0  # health-monitor period
    fail_threshold: int = 2        # consecutive failures before eviction
    connect_timeout_s: float = 0.5


class ClusterError(Exception):
    """Coordinator-level failure (configuration, not a worker fault)."""


def parse_addr(addr: Union[str, Tuple[str, int]]) -> Tuple[str, int]:
    if isinstance(addr, tuple):
        return addr[0], int(addr[1])
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


def round_robin_placement(n_shards: int, n_workers: int,
                          replication: int = 2,
                          hot_shards: Sequence[int] = ()
                          ) -> List[List[int]]:
    """k-way replicated round-robin shard→worker placement.

    ``placement[s]`` lists the workers holding shard ``s``, primary first.
    ``hot_shards`` get one extra replica — the knob for shards every query
    touches.  Replication is clamped to the worker count."""
    if n_workers <= 0:
        raise ClusterError("placement needs at least one worker")
    hot = set(int(s) for s in hot_shards)
    out = []
    for s in range(n_shards):
        k = min(max(int(replication), 1) + (1 if s in hot else 0), n_workers)
        out.append([(s + j) % n_workers for j in range(k)])
    return out


class WorkerClient:
    """Pooled wire-protocol client for one worker address.

    Sockets are checked out per call and returned on clean success; any
    failure closes the socket, so a poisoned stream (half-read frame,
    injected disconnect) never serves a second request — and closes every
    pooled socket too: they lead to the same peer, and after it restarts
    each would fail one more call (one more health probe) before a fresh
    connection reached the new process."""

    def __init__(self, addr, connect_timeout_s: float = 0.5,
                 max_bytes: int = wire.DEFAULT_MAX_BYTES):
        self.host, self.port = parse_addr(addr)
        self.addr = f"{self.host}:{self.port}"
        self.connect_timeout_s = float(connect_timeout_s)
        self.max_bytes = int(max_bytes)
        self._pool: List[socket.socket] = []
        self._lock = threading.Lock()

    def _checkout(self) -> socket.socket:
        with self._lock:
            if self._pool:
                return self._pool.pop()
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.connect_timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def call(self, obj: Dict, arrays: Optional[Dict] = None,
             timeout: Optional[float] = None) -> Tuple[Dict, Dict]:
        deadline = (time.monotonic() + timeout) if timeout else None
        sock = self._checkout()
        try:
            out = wire.call(sock, obj, arrays, deadline=deadline,
                            max_bytes=self.max_bytes)
        except BaseException:
            try:
                sock.close()
            except OSError:
                pass
            self.close()
            raise
        with self._lock:
            self._pool.append(sock)
        return out

    def close(self) -> None:
        with self._lock:
            pool, self._pool = self._pool, []
        for sock in pool:
            try:
                sock.close()
            except OSError:
                pass


class _WorkerState:
    __slots__ = ("up", "fails", "last_error")

    def __init__(self):
        self.up = True
        self.fails = 0
        self.last_error: Optional[str] = None


class ClusterService:
    """Scatter/gather query service over RPC shard workers.

    Statement-compatible with ``QueryService`` (``count`` / ``group_count``
    / ``top_k`` / ``query`` / ``query_batch`` / ``statement`` / ``stats``),
    so ``repro_torch.serve.query_api.make_server`` mounts it unchanged.  The
    coordinator holds only *metadata* of the index (a zero-copy mmap open:
    shard offsets, cardinalities, column names — no bitmap word is ever
    read locally); all bitmap work happens on the workers.
    """

    def __init__(self, index_dir: str, workers: Sequence,
                 replication: int = 2, policy: Optional[Policy] = None,
                 backend: str = "auto", max_rows: int = 10_000,
                 cache_entries: int = 256,
                 cache_bytes: Optional[int] = 64 << 20,
                 hot_shards: Sequence[int] = (),
                 placement: Optional[List[List[int]]] = None,
                 max_bytes: int = wire.DEFAULT_MAX_BYTES):
        if not workers:
            raise ClusterError("ClusterService needs at least one worker")
        self.index_dir = index_dir
        self.policy = policy or Policy()
        self.backend = backend
        self.max_rows = int(max_rows)
        # metadata-only open: offsets, cards, names (mmap => no payload IO)
        self.meta = ShardedIndex.load(index_dir, mmap=True)
        self.n_shards = self.meta.n_shards
        self.clients = [WorkerClient(a, self.policy.connect_timeout_s,
                                     max_bytes) for a in workers]
        self.replication = min(max(int(replication), 1), len(self.clients))
        self.placement = placement if placement is not None else \
            round_robin_placement(self.n_shards, len(self.clients),
                                  self.replication, hot_shards)
        if len(self.placement) != self.n_shards:
            raise ClusterError(
                f"placement covers {len(self.placement)} shards, store has "
                f"{self.n_shards}")
        self._states = [_WorkerState() for _ in self.clients]
        self._lock = threading.Lock()
        self._latencies: List[float] = []   # rolling RTT window (data ops)
        self._lat_cap = 256
        self.cache = LRUCache(capacity=cache_entries, max_bytes=cache_bytes,
                              sizeof=payload_nbytes, classify=payload_kind)
        self._generation = 0
        self._counters = {"tasks": 0, "hedges": 0, "hedge_wins": 0,
                          "failovers": 0, "retries": 0, "failures": 0,
                          "evictions": 0, "replacements": 0,
                          "degraded_queries": 0}
        self._pool = ThreadPoolExecutor(
            max_workers=max(8, min(4 * len(self.clients), 32)),
            thread_name_prefix="scatter")
        self._monitor: Optional[threading.Thread] = None
        self._monitor_stop: Optional[threading.Event] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self, monitor: bool = True) -> "ClusterService":
        """Push placement assignments to the workers, probe them once, and
        (optionally) start the background health monitor."""
        self.ensure_assignments()
        self.probe_all()
        if monitor:
            self.start_monitor()
        return self

    def ensure_assignments(self) -> None:
        """Idempotently tell every live worker which shards it should hold
        (workers launched with explicit ``--shards`` already hold them;
        ``assign`` of a held shard is a no-op)."""
        for w, client in enumerate(self.clients):
            shards = [s for s, reps in enumerate(self.placement) if w in reps]
            if not shards:
                continue
            try:
                client.call({"op": "assign", "shards": shards},
                            timeout=self.policy.deadline_s)
            except (OSError, wire.WireError):
                self._note_failure(w, "assign failed")

    def start_monitor(self) -> None:
        if self._monitor is not None:
            return
        self._monitor_stop = threading.Event()
        t = threading.Thread(target=self._monitor_loop, daemon=True,
                             name="cluster-health")
        self._monitor = t
        t.start()

    def stop_monitor(self) -> None:
        if self._monitor is None:
            return
        self._monitor_stop.set()
        self._monitor.join(timeout=5)
        self._monitor = None
        self._monitor_stop = None

    def _monitor_loop(self) -> None:
        while not self._monitor_stop.wait(self.policy.probe_interval_s):
            try:
                self.probe_all()
            except Exception:
                pass  # the monitor must outlive any single bad probe

    def close(self) -> None:
        self.stop_monitor()
        self._pool.shutdown(wait=False)
        for c in self.clients:
            c.close()

    # -- health / placement --------------------------------------------------
    def probe_all(self) -> List[bool]:
        """One health round: probe every worker, evict/readmit as needed.

        Ends with a placement repair pass: eviction-time re-placement is
        skipped for shards with no healthy candidate at that instant, so a
        later-recovering worker must be able to pick the slack up here
        (repair is level-triggered, not only eviction-edge-triggered)."""
        out = []
        for w in range(len(self.clients)):
            out.append(self.probe_worker(w))
        self._repair_placement()
        return out

    def probe_worker(self, w: int) -> bool:
        try:
            self.clients[w].call({"op": "health"},
                                 timeout=self.policy.connect_timeout_s
                                 + self.policy.hedge_min_s)
        except (OSError, wire.WireError, queue.Empty) as exc:
            self._note_failure(w, f"probe: {exc}")
            return False
        self._mark_ok(w)
        return True

    def _mark_ok(self, w: int) -> None:
        st = self._states[w]
        with self._lock:
            st.fails = 0
            was_down = not st.up
            st.up = True
        if was_down:
            # a recovered (possibly restarted) worker re-learns its shards
            shards = [s for s, reps in enumerate(self.placement) if w in reps]
            if shards:
                try:
                    self.clients[w].call({"op": "assign", "shards": shards},
                                         timeout=self.policy.deadline_s)
                except (OSError, wire.WireError):
                    pass

    def _note_failure(self, w: int, err) -> None:
        st = self._states[w]
        evict = False
        with self._lock:
            self._counters["failures"] += 1
            st.fails += 1
            st.last_error = str(err)
            if st.up and st.fails >= self.policy.fail_threshold:
                st.up = False
                evict = True
                self._counters["evictions"] += 1
        if evict:
            self._replace_worker(w)

    def _replace_worker(self, w: int) -> None:
        """Immediate repair pass after evicting worker ``w``."""
        self._repair_placement()

    def _repair_placement(self) -> None:
        """Re-place under-replicated shards onto healthy peers.

        For every shard with fewer live replicas than the replication
        factor allows, the least-loaded healthy worker not already holding
        the shard is appended to its replica list and told to ``assign``
        (mmap-open) it — restoring fault tolerance without restarting
        anything.  A no-op scan when the fleet is fully replicated, so it
        is safe to run on every probe round: shards that could not be
        repaired at eviction time (no healthy candidate yet) are picked up
        as soon as a worker recovers."""
        with self._lock:
            healthy = [x for x in range(len(self.clients))
                       if self._states[x].up]
            if not healthy:
                return
            load = {x: sum(1 for reps in self.placement if x in reps)
                    for x in healthy}
            to_assign: Dict[int, List[int]] = {}
            for sid, reps in enumerate(self.placement):
                live = [x for x in reps if self._states[x].up]
                if len(live) >= min(self.replication, len(healthy)):
                    continue
                cands = [x for x in healthy if x not in reps]
                if not cands:
                    continue
                pick = min(cands, key=lambda x: load[x])
                reps.append(pick)
                load[pick] += 1
                to_assign.setdefault(pick, []).append(sid)
                self._counters["replacements"] += 1
        for x, sids in to_assign.items():
            try:
                self.clients[x].call({"op": "assign", "shards": sids},
                                     timeout=self.policy.deadline_s)
            except (OSError, wire.WireError) as exc:
                self._note_failure(x, f"re-place assign: {exc}")

    def _replica_order(self, sid: int) -> List[int]:
        """Replicas of ``sid``, healthy first (placement order within each
        class) — the retry rotation walks this list."""
        with self._lock:
            reps = list(self.placement[sid])
            up = [w for w in reps if self._states[w].up]
            down = [w for w in reps if not self._states[w].up]
        return up + down

    # -- latency window / hedging --------------------------------------------
    def _record_latency(self, dt: float) -> None:
        with self._lock:
            self._latencies.append(dt)
            if len(self._latencies) > self._lat_cap:
                del self._latencies[: len(self._latencies) - self._lat_cap]

    def _hedge_delay(self) -> float:
        with self._lock:
            lats = list(self._latencies)
        if len(lats) >= 16:
            d = float(np.percentile(lats, self.policy.hedge_pctl))
        else:
            d = self.policy.hedge_after_s
        return min(max(d, self.policy.hedge_min_s),
                   self.policy.deadline_s / 2)

    # -- robust shard task ---------------------------------------------------
    def _attempt(self, w: int, obj: Dict, extract: Callable,
                 deadline: float, out_q: "queue.SimpleQueue",
                 hedged: bool) -> None:
        t0 = time.monotonic()
        try:
            remaining = deadline - t0
            if remaining <= 0:
                raise socket.timeout("shard-task deadline exceeded")
            out, arrs = self.clients[w].call(obj, timeout=remaining)
            val = extract(out, arrs)
            out_q.put((w, hedged, (val,), None, time.monotonic() - t0))
        except Exception as exc:  # noqa: BLE001 - fed into the policy
            out_q.put((w, hedged, None, exc, None))

    def _hedged_call(self, obj: Dict, extract: Callable, primary: int,
                     backup: Optional[int], deadline: float):
        """One retry round: primary call, speculative backup after the
        hedge delay (or immediately on a fast primary failure); first
        success wins.  Returns the extracted value or None."""
        out_q: "queue.SimpleQueue" = queue.SimpleQueue()
        launch = lambda w, hedged: threading.Thread(
            target=self._attempt, args=(w, obj, extract, deadline, out_q,
                                        hedged), daemon=True).start()
        launch(primary, False)
        pending = 1
        backup_launched = backup is None
        hedge_delay = self._hedge_delay()
        while pending:
            now = time.monotonic()
            if now >= deadline:
                break
            wait = (deadline - now) if backup_launched \
                else min(hedge_delay, deadline - now)
            try:
                w, hedged, res, exc, dt = out_q.get(timeout=wait)
            except queue.Empty:
                if not backup_launched:
                    # primary silent past the latency percentile: hedge
                    launch(backup, True)
                    pending += 1
                    backup_launched = True
                    with self._lock:
                        self._counters["hedges"] += 1
                    continue
                break  # deadline
            pending -= 1
            if exc is None:
                self._record_latency(dt)
                self._mark_ok(w)
                if hedged:
                    with self._lock:
                        self._counters["hedge_wins"] += 1
                return res[0]
            self._note_failure(w, exc)
            if not backup_launched:
                # primary failed fast (refused connection, corrupt frame):
                # fail over to the backup immediately, don't wait the hedge
                launch(backup, False)
                pending += 1
                backup_launched = True
                with self._lock:
                    self._counters["failovers"] += 1
        return None

    def _shard_task(self, sid: int, obj: Dict, extract: Callable):
        """Full robustness policy for one shard: deadline, hedged replica
        rounds, bounded retries with exponential backoff + jitter."""
        with self._lock:
            self._counters["tasks"] += 1
        p = self.policy
        deadline = time.monotonic() + p.deadline_s
        for attempt in range(p.retries + 1):
            order = self._replica_order(sid)
            if not order or time.monotonic() >= deadline:
                break
            primary = order[attempt % len(order)]
            backup = order[(attempt + 1) % len(order)] \
                if len(order) > 1 else None
            val = self._hedged_call(obj, extract, primary, backup, deadline)
            if val is not None:
                return val
            if attempt < p.retries:
                with self._lock:
                    self._counters["retries"] += 1
                delay = min(p.backoff_s * (2 ** attempt), p.backoff_max_s)
                delay *= 1 + p.jitter * random.random()
                time.sleep(max(0.0, min(delay,
                                        deadline - time.monotonic())))
        return None

    # -- scatter/gather ------------------------------------------------------
    def _scatter(self, op: str, e: Optional[Expr], col: Optional[int] = None,
                 measure: Optional[str] = None,
                 cols: Optional[Tuple[int, ...]] = None
                 ) -> Tuple[Dict[int, object], List[int]]:
        w = to_wire(e) if e is not None else None

        def mk(sid: int) -> Dict:
            obj = {"op": op, "shards": [sid]}
            if w is not None:
                obj["where"] = w
            if col is not None:
                obj["col"] = col
            if op in ("agg", "gagg"):
                obj["measure"] = measure
            if cols is not None:
                obj["cols"] = list(cols)
            return obj

        def extract(sid: int) -> Callable:
            if op == "count":
                return lambda out, arrs: int(out["counts"][str(sid)])
            if op == "gcount":
                return lambda out, arrs: np.asarray(arrs[f"g{sid}"],
                                                    dtype=np.int64)
            if op == "agg":
                # the scalar (sum, count, min, max) partial, JSON-shipped
                return lambda out, arrs: tuple(out["aggs"][str(sid)])
            if op == "gagg":
                def ex(out, arrs):
                    part = {"cols": tuple(out["cols"]),
                            "shape": tuple(out["shapes"][str(sid)]),
                            "measure": out["measure"],
                            "dtype": out["dtype"],
                            "counts": np.asarray(arrs[f"gc{sid}"],
                                                 dtype=np.int64)}
                    if out["measure"] is not None:
                        part["sums"] = np.asarray(arrs[f"gs{sid}"])
                        part["mins"] = np.asarray(arrs[f"gm{sid}"])
                        part["maxs"] = np.asarray(arrs[f"gx{sid}"])
                    return part
                return ex
            return lambda out, arrs: (
                np.asarray(arrs[f"w{sid}"]), int(out["n_bits"][str(sid)]))

        futs = {sid: self._pool.submit(self._shard_task, sid, mk(sid),
                                       extract(sid))
                for sid in range(self.n_shards)}
        results = {sid: f.result() for sid, f in futs.items()}
        missing = sorted(sid for sid, v in results.items() if v is None)
        if missing:
            with self._lock:
                self._counters["degraded_queries"] += 1
        return results, missing

    def _coverage(self, missing: List[int]) -> int:
        rows = np.diff(self.meta.offsets)
        return int(self.meta.n_rows - sum(int(rows[s]) for s in missing))

    # -- statements (QueryService-compatible) --------------------------------
    def _snapshot_key(self, kind: str, col, e: Optional[Expr]) -> tuple:
        return (self._generation, self.backend, kind, col,
                canonical_key(e) if e is not None else None)

    def count(self, where=None) -> Dict:
        e = self._as_expr(where)
        key = self._snapshot_key("count", None, e)
        hit = self.cache.get(key)
        if hit is not None:
            return {"select": "count", "count": int(hit), "exact": True,
                    "missing_shards": [], "covered_rows": self.meta.n_rows,
                    "cached": True}
        results, missing = self._scatter("count", e)
        total = sum(int(v) for v in results.values() if v is not None)
        if not missing:
            self.cache.put(key, total)
        return {"select": "count", "count": total, "exact": not missing,
                "missing_shards": missing,
                "covered_rows": self._coverage(missing), "cached": False}

    def group_count(self, col, where=None) -> Dict:
        e = self._as_expr(where)
        c = self.meta.resolve_column(col)
        key = self._snapshot_key("gcount", c, e)
        hit = self.cache.get(key)
        if hit is not None:
            return {"select": "group_count", "col": col,
                    "counts": [int(x) for x in hit], "exact": True,
                    "missing_shards": [], "covered_rows": self.meta.n_rows,
                    "cached": True}
        results, missing = self._scatter("gcount", e, col=c)
        out = np.zeros(self.meta.card(c), dtype=np.int64)
        for v in results.values():
            if v is not None:
                out += v
        if not missing:
            self.cache.put(key, out)
        return {"select": "group_count", "col": col,
                "counts": [int(x) for x in out], "exact": not missing,
                "missing_shards": missing,
                "covered_rows": self._coverage(missing), "cached": False}

    def top_k(self, col, k: int, where=None, measure=None) -> Dict:
        from repro_torch.core.dataset import top_k_from_counts, top_k_from_values
        if measure is None:
            out = self.group_count(col, where)
            top = top_k_from_counts(np.asarray(out["counts"]), int(k))
            return {"select": "top_k", "col": col, "k": int(k),
                    "measure": None,
                    "top": [[v, c] for v, c in top], "exact": out["exact"],
                    "missing_shards": out["missing_shards"],
                    "covered_rows": out["covered_rows"],
                    "cached": out["cached"]}
        # rank by SUM(measure): gather per-shard grouped-sum partials and
        # merge — each partial is one card(col)-long vector, so the wire
        # cost matches group_count, not a TPUT round trip per shard
        from repro_torch.core import measures as measures_mod
        self._check_measure(measure)
        e = self._as_expr(where)
        c = self.meta.resolve_column(col)
        agg, missing, cached = self._group_agg_raw(measure, (c,), e)
        vals = measures_mod.finalize_group("sum", agg)
        top = top_k_from_values(np.asarray(vals),
                                np.asarray(agg["counts"]), int(k))
        return {"select": "top_k", "col": col, "k": int(k),
                "measure": measure,
                "top": [[int(r), (int(v) if isinstance(v, (int, np.integer))
                                  else float(v))] for r, v in top],
                "exact": not missing, "missing_shards": missing,
                "covered_rows": self._coverage(missing), "cached": cached}

    # -- measure statements (compressed-domain OLAP) -------------------------
    def _check_measure(self, name) -> None:
        declared = list(getattr(self.meta, "measure_names", []) or [])
        if not isinstance(name, str) or name not in declared:
            raise KeyError(f"unknown measure {name!r}; this store declares "
                           f"{declared}")

    def agg(self, op: str, measure: str, where=None) -> Dict:
        """Scalar sum/avg/min/max of a measure: each worker ships one
        ``(sum, count, min, max)`` partial per shard, merged here."""
        from repro_torch.core import measures as measures_mod
        self._check_measure(measure)
        e = self._as_expr(where)
        key = self._snapshot_key(f"agg:{measure}", None, e)
        agg = self.cache.get(key)
        missing: List[int] = []
        cached = agg is not None
        if agg is None:
            results, missing = self._scatter("agg", e, measure=measure)
            parts = [v for v in results.values() if v is not None]
            agg = measures_mod.merge_scalar_aggs(parts)
            if not missing:
                self.cache.put(key, agg)
        val = measures_mod.finalize_scalar(op, agg)
        return {"select": op, "measure": measure, "value": val,
                "count": int(agg[1]), "exact": not missing,
                "missing_shards": missing,
                "covered_rows": self._coverage(missing), "cached": cached}

    def _group_agg_raw(self, measure: Optional[str],
                       cs: Tuple[int, ...], e: Optional[Expr]):
        """Scatter the grouped aggregate, merge the per-shard partial
        matrices.  Returns ``(merged_partial, missing, cached)``; partial
        results (missing shards skipped in the merge) are never cached."""
        from repro_torch.core import measures as measures_mod
        key = self._snapshot_key(f"gagg:{measure}", cs, e)
        hit = self.cache.get(key)
        if hit is not None:
            return hit, [], True
        results, missing = self._scatter("gagg", e, measure=measure,
                                         cols=cs)
        parts = [v for v in results.values() if v is not None]
        if parts:
            agg = measures_mod.merge_group_aggs(parts)
        else:
            shape = tuple(self.meta.card(c) for c in cs)
            dt = None
            if measure is not None:
                arr = self.meta.shards[0].measure(measure)
                dt = measures_mod.measure_dtype_str(arr)
            agg = measures_mod.empty_group_agg(cs, shape, measure, dt)
        if not missing:
            self.cache.put(key, agg)
        return agg, missing, False

    def group_agg(self, op: str, measure: Optional[str], by,
                  where=None) -> Dict:
        """Grouped sum/avg/min/max (or multi-column count when ``measure``
        is None) over 1-2 columns."""
        from repro_torch.core import measures as measures_mod
        if measure is not None:
            self._check_measure(measure)
        e = self._as_expr(where)
        cs = tuple(self.meta.resolve_column(c) for c in by)
        agg, missing, cached = self._group_agg_raw(measure, cs, e)
        shape = list(agg["shape"])

        def nest(flat):
            return np.asarray(flat).reshape(shape).tolist()

        out = {"select": "group_agg", "op": op, "measure": measure,
               "by": list(by), "shape": shape,
               "counts": nest(agg["counts"]), "exact": not missing,
               "missing_shards": missing,
               "covered_rows": self._coverage(missing), "cached": cached}
        if op != "count":
            from repro_torch.serve.query_api import nan_to_none
            out["values"] = nan_to_none(
                nest(measures_mod.finalize_group(op, agg)))
        return out

    def query(self, expr, explain_plan: bool = False) -> Dict:
        """Row query: per-shard EWAH results gathered and offset into
        global row ids (shard order == ascending id order, so the merged
        row list needs no sort)."""
        e = self._as_expr(expr)
        if e is None:
            raise ValueError("query needs an expression")
        key = self._snapshot_key("rows", None, e)
        hit = self.cache.get(key)
        if hit is not None:
            return self._rows_result(hit, [], cached=True)
        results, missing = self._scatter("execute", e)
        offsets = self.meta.offsets
        parts = []
        for sid in range(self.n_shards):
            v = results.get(sid)
            if v is None:
                continue
            words, n_bits = v
            bits = EWAH(np.ascontiguousarray(words), n_bits).set_bits()
            parts.append(bits.astype(np.int64) + int(offsets[sid]))
        rows = np.concatenate(parts) if parts \
            else np.empty(0, dtype=np.int64)
        if not missing:
            self.cache.put(key, rows)
        return self._rows_result(rows, missing, cached=False)

    def _rows_result(self, rows: np.ndarray, missing: List[int],
                     cached: bool) -> Dict:
        return {
            "count": int(len(rows)),
            "rows": rows[: self.max_rows].tolist(),
            "truncated": bool(len(rows) > self.max_rows),
            "exact": not missing,
            "missing_shards": missing,
            "covered_rows": self._coverage(missing),
            "cached": cached,
        }

    def query_batch(self, exprs: Sequence) -> List[Dict]:
        return [self.query(e) for e in exprs]

    def statement(self, obj: Dict) -> Dict:
        from repro_torch.serve.query_api import parse_statement
        st = parse_statement(obj)
        kind, e = st["kind"], st["where"]
        if kind == "count":
            return self.count(e)
        if kind == "group_count":
            return self.group_count(st["col"], e)
        if kind == "agg":
            return self.agg(st["op"], st["measure"], e)
        if kind == "group_agg":
            return self.group_agg(st["op"], st["measure"], st["by"], e)
        return self.top_k(st["col"], st["k"], e, measure=st["measure"])

    def sql(self, text: str) -> Dict:
        """Execute one SQL-ish statement (see ``query_api.parse_sql``)."""
        from repro_torch.serve.query_api import parse_sql
        return self.statement(parse_sql(text))

    @staticmethod
    def _as_expr(where) -> Optional[Expr]:
        if where is None or isinstance(where, Expr):
            return where
        from repro_torch.core.expr import from_wire
        return from_wire(where)

    # -- ops surface (HTTP admin endpoints) ----------------------------------
    def invalidate_cache(self) -> None:
        self.cache.clear()

    def reload_from_dir(self, mmap: bool = True) -> Dict:
        """Rolling reload: refresh the coordinator's metadata and run every
        worker's fingerprint-diff reload — each worker reopens only shards
        whose files changed, keeping sibling caches warm."""
        self.meta = ShardedIndex.load(self.index_dir, mmap=mmap)
        if self.meta.n_shards != self.n_shards:
            raise ClusterError(
                f"store now has {self.meta.n_shards} shards, placement "
                f"covers {self.n_shards}; relaunch the cluster to re-place")
        per_worker: Dict[str, object] = {}
        for w, client in enumerate(self.clients):
            if not self._states[w].up:
                per_worker[client.addr] = "down"
                continue
            try:
                out, _ = client.call({"op": "reload"},
                                     timeout=self.policy.deadline_s)
                per_worker[client.addr] = out.get("reloaded", [])
            except (OSError, wire.WireError) as exc:
                self._note_failure(w, f"reload: {exc}")
                per_worker[client.addr] = f"error: {exc}"
        self._generation += 1
        self.cache.clear()
        reloaded = sorted({s for v in per_worker.values()
                           if isinstance(v, list) for s in v})
        return {"reloaded": reloaded, "full": False,
                "n_shards": self.n_shards, "workers": per_worker}

    def scrub(self) -> Dict:
        """Scatter a full-CRC store audit to every live worker."""
        per_worker: Dict[str, object] = {}
        ok = True
        for w, client in enumerate(self.clients):
            if not self._states[w].up:
                per_worker[client.addr] = "down"
                continue
            try:
                out, _ = client.call({"op": "scrub"},
                                     timeout=max(self.policy.deadline_s, 30))
                per_worker[client.addr] = out
                ok = ok and bool(out.get("ok"))
            except (OSError, wire.WireError) as exc:
                self._note_failure(w, f"scrub: {exc}")
                per_worker[client.addr] = f"error: {exc}"
                ok = False
        return {"ok": ok, "workers": per_worker}

    def set_fault(self, w: int, config: Optional[Dict]) -> Dict:
        """Install (or clear, with ``None``) a fault injector on worker
        ``w`` — the chaos harness's remote control."""
        out, _ = self.clients[w].call({"op": "fault", "config": config},
                                      timeout=self.policy.deadline_s)
        return out

    # mutations are a single-writer concern; the coordinator is read-only
    def ingest(self, rows):
        raise ValueError("the cluster coordinator is read-only; ingest "
                         "through the single-writer live service")

    def delete(self, where):
        raise ValueError("the cluster coordinator is read-only; delete "
                         "through the single-writer live service")

    def compact(self):
        raise ValueError("the cluster coordinator is read-only; compact "
                         "through the single-writer live service")

    # -- stats ---------------------------------------------------------------
    def stats(self) -> Dict:
        with self._lock:
            lats = sorted(self._latencies)
            counters = dict(self._counters)
            workers = [{"addr": c.addr, "up": st.up, "fails": st.fails,
                        "last_error": st.last_error,
                        "shards": [s for s, reps in enumerate(self.placement)
                                   if w in reps]}
                       for w, (c, st) in enumerate(zip(self.clients,
                                                       self._states))]
        lat = {}
        if lats:
            lat = {"n": len(lats),
                   "p50_ms": float(np.percentile(lats, 50)) * 1e3,
                   "p95_ms": float(np.percentile(lats, 95)) * 1e3,
                   "max_ms": lats[-1] * 1e3}
        return {
            "n_rows": self.meta.n_rows,
            "n_columns": self.meta.n_columns,
            "n_shards": self.n_shards,
            "shard_rows": np.diff(self.meta.offsets).tolist(),
            "column_names": self.meta.column_names,
            "measures": sorted(getattr(self.meta, "measure_names", []) or []),
            "replication": self.replication,
            "placement": [list(r) for r in self.placement],
            "workers": workers,
            "hedge_delay_s": self._hedge_delay(),
            "latency": lat,
            "counters": counters,
            "cache": self.cache.stats(),
        }


def main(argv=None):
    from repro_torch.serve.query_api import make_server
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--index-dir", required=True)
    ap.add_argument("--workers", required=True,
                    help="comma-separated worker host:port list")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8321)
    ap.add_argument("--replication", type=int, default=2)
    ap.add_argument("--deadline", type=float, default=2.0)
    ap.add_argument("--retries", type=int, default=2)
    ap.add_argument("--hedge-after", type=float, default=0.25)
    ap.add_argument("--probe-interval", type=float, default=1.0)
    ap.add_argument("--max-body-bytes", type=int, default=None,
                    help="largest accepted HTTP request body (shared cap "
                         "with the workers' frame limit)")
    args = ap.parse_args(argv)
    policy = Policy(deadline_s=args.deadline, retries=args.retries,
                    hedge_after_s=args.hedge_after,
                    probe_interval_s=args.probe_interval)
    svc = ClusterService(args.index_dir, args.workers.split(","),
                         replication=args.replication, policy=policy)
    svc.start()
    srv = make_server(svc, args.host, args.port,
                      max_body_bytes=args.max_body_bytes)
    print(f"[cluster] coordinating {svc.n_shards} shards x "
          f"{len(svc.clients)} workers (r={svc.replication}) on "
          f"http://{args.host}:{srv.server_address[1]}", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
