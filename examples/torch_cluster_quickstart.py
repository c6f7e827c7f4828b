"""Cluster quickstart on the PyTorch port: one coordinator + three worker
processes serving a sharded index — then kill a worker mid-query and watch
replicas absorb it.

The counterpart of ``examples/cluster_quickstart.py``, with the same lines
and the same checks.  The workers are spawned ``repro_torch`` processes on
``--device`` (each one's torch import and CUDA start is its cold start);
under ``ewah`` they answer on the host, as the reference's do.

The topology this walks through:

    LocalCluster(index_dir, n_workers=3, replication=2)
        -> 3 OS processes, each mmap-opening its assigned shard files
        -> k-way round-robin shard placement, primary + replica per shard
    svc.count / group_count / top_k    -> scatter to workers, gather exact
    cluster.set_fault(w, {...})        -> seeded delay on one worker:
                                          hedged requests beat the straggler
    cluster.kill_worker(w)             -> SIGKILL mid-workload: replicas
                                          answer, the coordinator evicts the
                                          corpse and re-replicates its shards
    svc.stats()                        -> hedges / failovers / evictions

Every answer along the way is asserted bit-identical to a single-process
``QueryService`` over the same store files.

    PYTHONPATH=src python examples/torch_cluster_quickstart.py [--device cpu]

``--device`` defaults to ``cuda`` and raises without CUDA; ``--device
cpu`` runs everything on the CPU.  ``--rows`` (default 60,000, the
reference's) sizes the store.  It spawns its workers: run it as a script
or from a module guarded by ``if __name__ == "__main__"``.
"""
import argparse
import os
import shutil
import tempfile
import time

import numpy as np

from repro_torch.core import ShardedIndex, col, lex_sort, synth
from repro_torch.distributed.cluster import Policy
from repro_torch.kernels.ops import resolve_device
from repro_torch.launch.cluster import LocalCluster
from repro_torch.serve.query_api import QueryService

BACKEND = "ewah"
STARTUP_S = 180.0   # a worker's torch import and CUDA start, cold


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=60_000)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    workdir = tempfile.mkdtemp(prefix="repro-torch-cluster-")
    try:
        _run(workdir, args.rows, device)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(workdir, n_rows, device):
    rng = np.random.default_rng(0)

    # a sharded store on disk — the same files every serving tier reads
    table, _ = synth.factorize(synth.census_like_table(n_rows, rng))
    table = table[lex_sort(table)]
    idx = ShardedIndex.build(table, shard_rows=8192, k=2,
                             column_names=["region", "day", "user"])
    index_dir = os.path.join(workdir, "store")
    idx.save(index_dir)
    print(f"store: {idx.n_rows} rows in {idx.n_shards} shards "
          f"-> {index_dir}")

    # the single-process reference everything must agree with, bit for bit
    mono = QueryService(ShardedIndex.load(index_dir, mmap=True),
                        backend=BACKEND, device=device)
    where = (col("region") == 2) & ~(col("day") == 1)
    ref = mono.count(where)["count"]

    policy = Policy(deadline_s=10.0, retries=2, hedge_min_s=0.05,
                    probe_interval_s=0.25)
    with LocalCluster(index_dir, n_workers=3, replication=2,
                      backend=BACKEND, policy=policy,
                      startup_timeout_s=STARTUP_S, device=device) as cluster:
        svc = cluster.service
        print(f"cluster: {idx.n_shards} shards x 3 worker processes, "
              f"2 replicas each (logs: {cluster.log_dir})")

        # --- scatter/gather, exact ----------------------------------------
        out = svc.count(where)
        assert out["count"] == ref and out["exact"]
        top = svc.top_k("region", 3, where)
        assert top["top"] == mono.top_k("region", 3, where)["top"]
        print(f"count: {out['count']} (exact={out['exact']}, "
              f"covered {out['covered_rows']} rows), "
              f"top regions {top['top']}")

        # --- a straggling worker: hedged requests win ---------------------
        # worker 1 delays every data response; after the p95-adaptive hedge
        # delay the coordinator races the replica and takes the first answer
        cluster.set_fault(1, {"seed": 11, "delay": 1.0, "delay_s": 0.5})
        svc.cache.clear()
        t0 = time.perf_counter()
        out = svc.count(where)
        dt = time.perf_counter() - t0
        cluster.set_fault(1, None)
        c = svc.stats()["counters"]
        assert out["count"] == ref and out["exact"]
        print(f"slow worker: still exact in {dt * 1e3:.0f} ms "
              f"({c['hedges']} hedges, {c['hedge_wins']} won)")

        # --- kill a worker mid-workload -----------------------------------
        victim = 2
        cluster.kill_worker(victim)  # SIGKILL, no goodbye
        svc.cache.clear()
        out = svc.count(where)  # replicas answer; retry/failover inside
        assert out["count"] == ref and out["exact"]
        assert out["missing_shards"] == []
        print(f"killed worker {victim} mid-workload: count {out['count']} "
              f"still exact via replicas")

        # the health monitor evicts the corpse and re-replicates its shards
        # onto the survivors (cheap: they mmap the same store files)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            stats = svc.stats()
            live = {w for w in range(3) if stats["workers"][w]["up"]}
            if victim not in live and all(
                    len([w for w in reps if w in live]) >= 2
                    for reps in stats["placement"]):
                break
            time.sleep(0.05)
        c = stats["counters"]
        assert c["evictions"] >= 1
        print(f"recovered: worker {victim} evicted, "
              f"{c['replacements']} shard replicas re-placed; every shard "
              f"back to 2 live copies")

        svc.cache.clear()
        out = svc.count(where)
        assert out["count"] == ref and out["exact"]
        print(f"counters: {c}")


if __name__ == "__main__":
    main()
