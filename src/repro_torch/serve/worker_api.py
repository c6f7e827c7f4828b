"""Shard worker: one process serving a subset of a sharded index over RPC.

The scatter/gather tier's data plane.  A ``ShardWorker`` mmap-opens an
*assigned subset* of the shard store files written by
``ShardedIndex.save`` — the same per-shard files + manifest the
single-process service warm-starts from — and serves shard statement tasks
over the length-prefixed, CRC-framed wire protocol
(``repro_torch.distributed.wire``).  Execution goes through
``repro_torch.core.shard.run_shard_task``, the *same* per-shard path the
in-process fan-out uses, so a worker's partial counts, count vectors and
EWAH slices are bit-identical to what the mono ``ShardedIndex`` would have
computed for that shard.  The worker runs the shards' kernel path on its
``device`` (``"cuda"`` by default, raising without a card; ``"cpu"`` runs
the plain versions), and every response encodes to the reference worker's
bytes: counts and vectors are host NumPy values, EWAH slices ship as
``WORD_DTYPE`` (uint32) words.

Operations (request ``{"op": ...}``, one response frame per request):

* ``count``    — ``{"shards": [...], "where": wire-expr|null}`` ->
  per-shard row counts.
* ``gcount``   — ``+ {"col": int}`` -> per-shard int64 count vectors
  (binary section).
* ``agg``      — ``+ {"measure": str}`` -> per-shard ``[sum, count, min,
  max]`` scalar measure partials (JSON; ``min``/``max`` null when the
  shard's filtered slice is empty).
* ``gagg``     — ``+ {"measure": str|null, "cols": [int, ...]}`` -> per-
  shard grouped-aggregate partials: a ``gc<i>`` counts array per shard
  (binary section) plus ``gs<i>``/``gm<i>``/``gx<i>`` sum/min/max arrays
  when a measure is named, with the group ``shape`` in the JSON object.
  ``measure=null`` computes multi-column counts only.
* ``execute``  — per-shard EWAH result words (binary section) + bit widths.
* ``health``   — liveness probe: pid, held shards, generation.
* ``assign``   — mmap-open additional shards (coordinator re-placement
  after a peer eviction; cheap — metadata-only open).
* ``retire``   — drop shards (rebalancing).
* ``reload``   — fingerprint-diff reload of held shards: only files that
  changed on disk are reopened, unchanged shards keep their warm
  result caches (the ``/admin/reload`` discipline, per worker).
* ``scrub``    — full CRC audit of the held shard files
  (``repro_torch.core.store.scrub``); corrupt segments reported per shard.
* ``fault``    — install/clear a deterministic ``FaultInjector`` on the
  response path (chaos tests and the chaos benchmark drive this remotely).
* ``stats``    — per-shard cache stats + fault counters.

Faults apply only to data-plane responses (``count``/``gcount``/
``execute``): admin ops stay reliable so the harness can always steer the
chaos, and health probes report the truth — a probe failure means the
worker is actually gone, not that the injector ate the frame.

Run standalone::

    PYTHONPATH=src python -m repro_torch.serve.worker_api \
        --index-dir /tmp/idx --shards 0,2 --port 9101 [--device cpu]

On a CUDA device ``main`` creates the CUDA context and loads and launches
``logical_reduce`` once before it binds its port (``warm_device``), so a
worker that answers ``health`` is ready: no first statement pays the
card's cold start inside a coordinator's deadline.
"""
from __future__ import annotations

import argparse
import os
import socket
import threading
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import store as index_store
from repro_torch.core.ewah import WORD_DTYPE
from repro_torch.core.expr import canonical_key, from_wire
from repro_torch.core.lru import LRUCache, payload_kind, payload_nbytes
from repro_torch.core.shard import run_shard_task
from repro_torch.distributed import wire
from repro_torch.kernels.ops import resolve_device

WORKER_CACHE_ENTRIES = 64
WORKER_CACHE_BYTES = 16 << 20

_DATA_OPS = ("count", "gcount", "agg", "gagg", "execute")

Device = Union[str, torch.device]


def warm_device(device: Device) -> torch.device:
    """Ready ``device`` for statements: on CUDA, create the context, load
    ``logical_reduce``'s library (built first if it is not) and launch it
    once; nothing to do on the CPU.  Returns the resolved device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import ops
        rows = torch.zeros((2, 1024), dtype=torch.int32, device=dev)
        ops.logical_reduce(rows, op="or")
        torch.cuda.synchronize(dev)
    return dev


class ShardWorker:
    """Holds mmap-opened shards + per-shard result caches; handles one op.

    Statements run their kernel path on ``device`` (``"cuda"`` by default;
    raises when CUDA is absent), each shard keeping its dense operands
    there for as long as the worker holds it."""

    def __init__(self, index_dir: str, shard_ids: Sequence[int],
                 backend: str = "auto", mmap: bool = True,
                 cache_entries: int = WORKER_CACHE_ENTRIES,
                 cache_bytes: Optional[int] = WORKER_CACHE_BYTES,
                 fault: Optional[wire.FaultInjector] = None,
                 max_bytes: int = wire.DEFAULT_MAX_BYTES,
                 device: Device = "cuda"):
        self.device = resolve_device(device)
        self.index_dir = index_dir
        self.backend = backend
        self.mmap = mmap
        self.max_bytes = int(max_bytes)
        self._cache_entries = cache_entries
        self._cache_bytes = cache_bytes
        self.fault = fault
        self.generation = 0
        self._lock = threading.RLock()
        self.shards: Dict[int, object] = {}
        self._prints: Dict[int, tuple] = {}
        self._caches: Dict[int, LRUCache] = {}
        for i in shard_ids:
            self._open_shard(int(i))

    # -- shard lifecycle -----------------------------------------------------
    def _fingerprint(self, name: str) -> tuple:
        st = os.stat(os.path.join(self.index_dir, name))
        return (name, st.st_mtime_ns, st.st_size)

    def _open_shard(self, i: int) -> None:
        names = index_store.manifest_shards(self.index_dir)
        if not (0 <= i < len(names)):
            raise ValueError(f"shard {i} out of range: manifest names "
                             f"{len(names)} shards")
        path = os.path.join(self.index_dir, names[i])
        self.shards[i] = index_store.load(path, mmap=self.mmap)
        self._prints[i] = self._fingerprint(names[i])
        self._caches[i] = LRUCache(capacity=self._cache_entries,
                                   max_bytes=self._cache_bytes,
                                   sizeof=payload_nbytes,
                                   classify=payload_kind)

    def assign(self, ids: Sequence[int]) -> Dict:
        with self._lock:
            opened = []
            for i in ids:
                i = int(i)
                if i not in self.shards:
                    self._open_shard(i)
                    opened.append(i)
            if opened:
                self.generation += 1
            return {"ok": True, "opened": opened,
                    "shards": sorted(self.shards)}

    def retire(self, ids: Sequence[int]) -> Dict:
        with self._lock:
            dropped = []
            for i in ids:
                i = int(i)
                if i in self.shards:
                    del self.shards[i]
                    del self._prints[i]
                    del self._caches[i]
                    dropped.append(i)
            if dropped:
                self.generation += 1
            return {"ok": True, "retired": dropped,
                    "shards": sorted(self.shards)}

    def reload(self) -> Dict:
        """Fingerprint-diff reload of held shards: reopen exactly the files
        that changed on disk; unchanged shards keep object and warm cache."""
        with self._lock:
            names = index_store.manifest_shards(self.index_dir)
            changed = []
            for i in sorted(self.shards):
                if i >= len(names):
                    continue  # manifest shrank; coordinator re-places
                try:
                    fresh = self._fingerprint(names[i])
                except OSError:
                    continue  # mid-replace; next reload sees it whole
                if fresh != self._prints.get(i):
                    self._open_shard(i)
                    changed.append(i)
            if changed:
                self.generation += 1
            return {"ok": True, "reloaded": changed,
                    "shards": sorted(self.shards)}

    def scrub(self) -> Dict:
        with self._lock:
            names = index_store.manifest_shards(self.index_dir)
            held = sorted(self.shards)
        reports = []
        for i in held:
            rep = index_store.scrub(os.path.join(self.index_dir, names[i]))
            rep["shard"] = i
            rep["file"] = names[i]
            reports.append(rep)
        return {"ok": all(r["ok"] for r in reports), "shards": reports,
                "n_corrupt_segments": sum(len(r["corrupt"])
                                          for r in reports)}

    # -- statement execution -------------------------------------------------
    def _run(self, i: int, task, ckey) -> object:
        with self._lock:
            sh = self.shards.get(i)
            cache = self._caches.get(i)
        if sh is None:
            raise KeyError(i)
        if ckey is not None and cache is not None:
            hit = cache.get(ckey)
            if hit is not None:
                return hit
        out = run_shard_task(sh, task, backend=self.backend,
                             device=self.device)
        if ckey is not None and cache is not None:
            cache.put(ckey, out)
        return out

    def handle(self, obj: Dict, arrays: Dict) -> tuple:
        """One request -> ``(response_obj, response_arrays)``.

        Raises ``ValueError`` for malformed requests (mapped to an error
        frame by the server loop).
        """
        op = obj.get("op")
        if op == "health":
            return ({"ok": True, "pid": os.getpid(),
                     "shards": sorted(self.shards),
                     "generation": self.generation}, {})
        if op == "assign":
            return (self.assign(obj.get("shards") or []), {})
        if op == "retire":
            return (self.retire(obj.get("shards") or []), {})
        if op == "reload":
            return (self.reload(), {})
        if op == "scrub":
            return (self.scrub(), {})
        if op == "fault":
            cfg = obj.get("config")
            self.fault = wire.FaultInjector.from_config(cfg)
            return ({"ok": True, "config": cfg or None}, {})
        if op == "stats":
            return ({"ok": True, "pid": os.getpid(),
                     "shards": sorted(self.shards),
                     "generation": self.generation,
                     "caches": {str(i): c.stats()
                                for i, c in sorted(self._caches.items())},
                     "fault": (self.fault.counts
                               if self.fault is not None else None)}, {})
        if op not in _DATA_OPS:
            raise ValueError(f"unknown worker op {op!r}")

        sids = [int(s) for s in (obj.get("shards") or [])]
        w = obj.get("where")
        e = from_wire(w) if w is not None else None
        ck = canonical_key(e) if e is not None else None
        missing: List[int] = []
        out: Dict = {"ok": True, "op": op}
        arrs: Dict[str, np.ndarray] = {}
        if op == "count":
            counts = {}
            for i in sids:
                try:
                    counts[str(i)] = int(self._run(
                        i, ("count", e), ("count", self.backend, ck)))
                except KeyError:
                    missing.append(i)
            out["counts"] = counts
        elif op == "gcount":
            col = obj.get("col")
            if not isinstance(col, int):
                raise ValueError(f"gcount needs an integer 'col', got {col!r}")
            for i in sids:
                try:
                    vec = self._run(i, ("gcount", col, e),
                                    ("gcount", col, self.backend, ck))
                except KeyError:
                    missing.append(i)
                    continue
                arrs[f"g{i}"] = np.asarray(vec, dtype=np.int64)
        elif op == "agg":
            name = obj.get("measure")
            if not isinstance(name, str):
                raise ValueError(f"agg needs a 'measure' name, got {name!r}")
            aggs = {}
            for i in sids:
                try:
                    part = self._run(i, ("agg", name, e),
                                     ("agg", name, self.backend, ck))
                except KeyError:
                    missing.append(i)
                    continue
                s, cnt, mn, mx = part
                aggs[str(i)] = [s, cnt, mn, mx]
            out["aggs"] = aggs
        elif op == "gagg":
            name = obj.get("measure")
            if name is not None and not isinstance(name, str):
                raise ValueError(f"gagg 'measure' must be a name or null, "
                                 f"got {name!r}")
            cols = obj.get("cols")
            if (not isinstance(cols, list) or not (1 <= len(cols) <= 2)
                    or not all(isinstance(c, int) for c in cols)):
                raise ValueError(f"gagg needs 'cols' as a list of 1-2 "
                                 f"integer columns, got {cols!r}")
            cols = tuple(cols)
            shapes = {}
            dtype = None
            for i in sids:
                try:
                    g = self._run(i, ("gagg", name, cols, e),
                                  ("gagg", name, cols, self.backend, ck))
                except KeyError:
                    missing.append(i)
                    continue
                shapes[str(i)] = list(g["shape"])
                dtype = g["dtype"]
                arrs[f"gc{i}"] = np.asarray(g["counts"], dtype=np.int64)
                if name is not None:
                    arrs[f"gs{i}"] = np.asarray(g["sums"])
                    arrs[f"gm{i}"] = np.asarray(g["mins"])
                    arrs[f"gx{i}"] = np.asarray(g["maxs"])
            out["shapes"] = shapes
            out["cols"] = list(cols)
            out["measure"] = name
            out["dtype"] = dtype
        else:  # execute
            n_bits = {}
            for i in sids:
                try:
                    bm = self._run(i, ("expr", e),
                                   ("expr", self.backend, ck))
                except KeyError:
                    missing.append(i)
                    continue
                arrs[f"w{i}"] = np.asarray(bm.words, dtype=WORD_DTYPE)
                n_bits[str(i)] = int(bm.n_bits)
            out["n_bits"] = n_bits
        out["missing"] = missing
        return out, arrs


class WorkerServer:
    """Threaded TCP server: one connection thread, frames served in order.

    The fault injector (if installed) runs on the *send* side of data-plane
    responses, so drop/delay/corrupt/disconnect all happen after the worker
    computed a correct answer — exactly the window where a coordinator
    without CRC framing would merge garbage.
    """

    def __init__(self, worker: ShardWorker, host: str = "127.0.0.1",
                 port: int = 0):
        self.worker = worker
        self._sock = socket.create_server((host, port))
        self.host, self.port = self._sock.getsockname()[:2]
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        self._accept_thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "WorkerServer":
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name=f"worker-accept-{self.port}")
        self._accept_thread = t
        t.start()
        return self

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return  # listener closed
            self._conns.append(conn)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            self._threads.append(t)
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                try:
                    _kind, payload = wire.recv_frame(
                        conn, max_bytes=self.worker.max_bytes)
                except wire.WireTooLargeError as exc:
                    # stream is out of sync past an oversized header:
                    # answer once, then close
                    try:
                        wire.send_frame(conn, wire.KIND_ERR, wire.encode_msg(
                            {"error": str(exc), "code": "too_large"}))
                    except OSError:
                        pass
                    return
                except (wire.WireError, ConnectionError, socket.timeout,
                        OSError):
                    return
                injector = None
                try:
                    obj, arrays = wire.decode_msg(payload)
                    if obj.get("op") in _DATA_OPS:
                        injector = self.worker.fault
                    out, arrs = self.worker.handle(obj, arrays)
                    frame = (wire.KIND_RESP, wire.encode_msg(out, arrs))
                except (ValueError, KeyError, TypeError,
                        index_store.StoreError, wire.WireError) as exc:
                    frame = (wire.KIND_ERR, wire.encode_msg(
                        {"error": str(exc), "code": "bad_request"}))
                try:
                    wire.send_frame(conn, frame[0], frame[1],
                                    injector=injector)
                except OSError:
                    return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def stop(self) -> None:
        """Stop serving *abruptly*, like a crashed process: the listener and
        every live connection close, so in-flight peers see a reset — the
        failure the coordinator's robustness policy must absorb."""
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        for conn in self._conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--index-dir", required=True,
                    help="sharded store directory (manifest + shard files)")
    ap.add_argument("--shards", default="all",
                    help="comma-separated shard ids to serve, or 'all'")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "ewah", "kernel"])
    ap.add_argument("--device", default="cuda",
                    help="where the kernel path runs: cuda (default; "
                         "raises without a card) or cpu")
    ap.add_argument("--max-bytes", type=int,
                    default=wire.DEFAULT_MAX_BYTES,
                    help="largest accepted request frame payload")
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--fault-drop", type=float, default=0.0)
    ap.add_argument("--fault-delay", type=float, default=0.0)
    ap.add_argument("--fault-corrupt", type=float, default=0.0)
    ap.add_argument("--fault-disconnect", type=float, default=0.0)
    ap.add_argument("--fault-delay-s", type=float, default=0.25)
    args = ap.parse_args(argv)
    # ready before the port is bound: a worker that answers health is warm
    device = warm_device(args.device)
    if args.shards == "all":
        ids = list(range(len(index_store.manifest_shards(args.index_dir))))
    else:
        ids = [int(s) for s in args.shards.split(",") if s.strip() != ""]
    fault = None
    if args.fault_drop or args.fault_delay or args.fault_corrupt \
            or args.fault_disconnect:
        fault = wire.FaultInjector(
            seed=args.fault_seed, drop=args.fault_drop,
            delay=args.fault_delay, corrupt=args.fault_corrupt,
            disconnect=args.fault_disconnect, delay_s=args.fault_delay_s)
    worker = ShardWorker(args.index_dir, ids, backend=args.backend,
                         fault=fault, max_bytes=args.max_bytes,
                         device=device)
    srv = WorkerServer(worker, args.host, args.port).start()
    print(f"[worker] pid={os.getpid()} serving shards {ids} of "
          f"{args.index_dir} on {srv.address} (device={device})", flush=True)
    threading.Event().wait()


if __name__ == "__main__":
    main()
