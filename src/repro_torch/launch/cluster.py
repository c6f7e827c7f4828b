"""One-command local cluster topology: N shard workers + a coordinator.

``LocalCluster`` spawns ``repro_torch.serve.worker_api`` workers as real OS
processes (so a chaos test can ``kill -9`` one and watch the replicas take
over), computes the same k-way ``round_robin_placement`` the coordinator
uses, launches each worker already holding its assigned shards, waits for
the fleet to answer health probes, and hands back a started
``ClusterService``.  Everything a fault-injection harness needs is a
method: ``kill_worker`` (hard crash), ``restart_worker`` (recovery),
``set_fault`` (seeded drop/delay/corrupt/disconnect on a live worker).

Every worker runs the kernel path on ``device`` (``"cuda"`` by default —
all workers share the one card, each with its own CUDA context and its own
dense copy of the shards it holds; ``"cpu"`` runs the plain versions).  A
worker warms its device before it binds its port, so ``ready_s[w]``, the
seconds from spawn to the first answered health probe, includes the
torch import and the card's cold start.

Typical test / benchmark shape::

    with LocalCluster(index_dir, n_workers=3, replication=2) as cluster:
        svc = cluster.service
        out = svc.count(EQ)           # scatter/gather over 3 processes
        cluster.kill_worker(0)        # chaos: hard-kill one worker
        out = svc.count(EQ)           # replicas answer; still exact

CLI — build a demo store (or serve an existing one) and run the whole
topology in the foreground::

    PYTHONPATH=src python -m repro_torch.launch.cluster \
        --rows 200000 --shards 8 --n-workers 3 --port 8321 [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Union

import torch

from repro_torch.core import store as index_store
from repro_torch.distributed import wire
from repro_torch.distributed.cluster import (ClusterService, ClusterError, Policy,
                                       round_robin_placement)
from repro_torch.kernels.ops import resolve_device


def free_port(host: str = "127.0.0.1") -> int:
    """Ask the kernel for an ephemeral port (bind-0, read, close).  Small
    reuse race, fine for a local harness."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


class LocalCluster:
    """Subprocess worker fleet + in-process coordinator over one store dir."""

    def __init__(self, index_dir: str, n_workers: int = 3,
                 replication: int = 2, policy: Optional[Policy] = None,
                 backend: str = "auto", host: str = "127.0.0.1",
                 hot_shards: Sequence[int] = (),
                 log_dir: Optional[str] = None,
                 fault: Optional[Dict] = None,
                 start_monitor: bool = True,
                 startup_timeout_s: float = 20.0,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.startup_timeout_s = float(startup_timeout_s)
        self.index_dir = index_dir
        self.host = host
        self.backend = backend
        self.n_workers = int(n_workers)
        self.log_dir = log_dir or tempfile.mkdtemp(prefix="cluster-logs-")
        self.n_shards = len(index_store.manifest_shards(index_dir))
        self.placement = round_robin_placement(self.n_shards, self.n_workers,
                                               replication, hot_shards)
        self.ports = [free_port(host) for _ in range(self.n_workers)]
        self.procs: List[Optional[subprocess.Popen]] = [None] * self.n_workers
        self._logs: List[Optional[object]] = [None] * self.n_workers
        self._spawned_at: List[float] = [0.0] * self.n_workers
        self.ready_s: List[Optional[float]] = [None] * self.n_workers
        self._fault = fault
        self.service: Optional[ClusterService] = None
        try:
            for w in range(self.n_workers):
                self._spawn(w)
            self.wait_healthy(timeout_s=startup_timeout_s)
            self.service = ClusterService(
                index_dir, [(host, p) for p in self.ports],
                replication=replication, policy=policy, backend=backend,
                placement=[list(r) for r in self.placement])
            self.service.start(monitor=start_monitor)
        except BaseException:
            self.close()  # a failed start leaves no worker process behind
            raise

    # -- worker lifecycle ----------------------------------------------------
    def _worker_shards(self, w: int) -> List[int]:
        return [s for s, reps in enumerate(self.placement) if w in reps]

    def _spawn(self, w: int) -> None:
        shards = self._worker_shards(w)
        cmd = [sys.executable, "-m", "repro_torch.serve.worker_api",
               "--index-dir", self.index_dir,
               "--shards", ",".join(map(str, shards)),
               "--host", self.host, "--port", str(self.ports[w]),
               "--backend", self.backend, "--device", str(self.device)]
        if self._fault:
            for key, flag in (("seed", "--fault-seed"),
                              ("drop", "--fault-drop"),
                              ("delay", "--fault-delay"),
                              ("corrupt", "--fault-corrupt"),
                              ("disconnect", "--fault-disconnect"),
                              ("delay_s", "--fault-delay-s")):
                if key in self._fault:
                    cmd += [flag, str(self._fault[key])]
        env = dict(os.environ)
        src = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        extra = env.get("PYTHONPATH")
        env["PYTHONPATH"] = src + (os.pathsep + extra if extra else "")
        log = open(os.path.join(self.log_dir, f"worker-{w}.log"), "ab")
        self._logs[w] = log
        self.ready_s[w] = None
        self._spawned_at[w] = time.monotonic()
        self.procs[w] = subprocess.Popen(cmd, stdout=log, stderr=log,
                                         env=env)

    def _probe(self, w: int, timeout_s: float = 0.5) -> bool:
        try:
            sock = socket.create_connection((self.host, self.ports[w]),
                                            timeout=timeout_s)
        except OSError:
            return False
        try:
            wire.call(sock, {"op": "health"},
                      deadline=time.monotonic() + timeout_s)
            if self.ready_s[w] is None:
                self.ready_s[w] = time.monotonic() - self._spawned_at[w]
            return True
        except (OSError, wire.WireError):
            return False
        finally:
            sock.close()

    def wait_healthy(self, timeout_s: float = 20.0) -> None:
        """Block until every spawned worker answers a health probe."""
        deadline = time.monotonic() + timeout_s
        pending = [w for w in range(self.n_workers)
                   if self.procs[w] is not None]
        while pending and time.monotonic() < deadline:
            pending = [w for w in pending if not self._probe(w)]
            if pending:
                dead = [w for w in pending
                        if self.procs[w].poll() is not None]
                if dead:
                    raise ClusterError(
                        f"workers {dead} exited during startup; see logs "
                        f"in {self.log_dir}")
                time.sleep(0.05)
        if pending:
            raise ClusterError(f"workers {pending} not healthy after "
                               f"{timeout_s:.0f}s; see logs in {self.log_dir}")

    def kill_worker(self, w: int, sig: int = signal.SIGKILL) -> None:
        """Hard-crash a worker (chaos primitive).  The coordinator notices
        via failed calls / health probes and re-places its shards."""
        proc = self.procs[w]
        if proc is not None and proc.poll() is None:
            proc.send_signal(sig)
            proc.wait(timeout=10)

    def restart_worker(self, w: int) -> None:
        """Bring a killed worker back on its old port with its old shards."""
        self.kill_worker(w)
        self._spawn(w)
        deadline = time.monotonic() + self.startup_timeout_s
        while not self._probe(w):
            if time.monotonic() > deadline:
                raise ClusterError(f"worker {w} did not come back; see "
                                   f"logs in {self.log_dir}")
            time.sleep(0.05)

    def set_fault(self, w: int, config: Optional[Dict]) -> Dict:
        """Install (or clear) a seeded ``FaultInjector`` on live worker
        ``w`` without restarting it."""
        return self.service.set_fault(w, config)

    # -- teardown ------------------------------------------------------------
    def close(self) -> None:
        if getattr(self, "service", None) is not None:
            self.service.close()
        for w, proc in enumerate(self.procs):
            if proc is not None and proc.poll() is None:
                proc.kill()
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass
        for log in self._logs:
            if log is not None:
                log.close()

    def __enter__(self) -> "LocalCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def build_demo_store(out_dir: str, n_rows: int = 100_000,
                     n_shards: int = 8) -> str:
    """Build the demo census-like sharded index and save it to ``out_dir``."""
    from repro_torch.serve.query_api import _demo_index
    idx = _demo_index(n_rows, shards=max(n_shards, 2))
    idx.save(out_dir)
    return out_dir


def main(argv=None):
    from repro_torch.serve.query_api import make_server
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--index-dir", default=None,
                    help="serve an existing store dir (default: build a "
                         "demo store in a temp dir)")
    ap.add_argument("--rows", type=int, default=100_000)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--n-workers", type=int, default=3)
    ap.add_argument("--replication", type=int, default=2)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--device", default="cuda",
                    help="where the workers run the kernel path: cuda "
                         "(default; raises without a card) or cpu")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8321)
    ap.add_argument("--max-body-bytes", type=int, default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    index_dir = args.index_dir
    if index_dir is None:
        index_dir = tempfile.mkdtemp(prefix="cluster-store-")
        print(f"[cluster] building demo store ({args.rows} rows, "
              f"{args.shards} shards) in {index_dir}", flush=True)
        build_demo_store(index_dir, args.rows, args.shards)
    with LocalCluster(index_dir, n_workers=args.n_workers,
                      replication=args.replication,
                      backend=args.backend, host=args.host,
                      device=device) as cluster:
        srv = make_server(cluster.service, args.host, args.port,
                          max_body_bytes=args.max_body_bytes)
        print(f"[cluster] {cluster.n_shards} shards x {args.n_workers} "
              f"workers (r={args.replication}) on "
              f"http://{args.host}:{srv.server_address[1]} "
              f"(device={cluster.device}, worker logs: {cluster.log_dir})",
              flush=True)
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass


if __name__ == "__main__":
    main()
