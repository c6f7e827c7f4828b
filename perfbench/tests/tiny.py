"""Shared set-up of the CPU tests: a tiny run of a cell, on the CPU, with
the shard fan-out on threads (no forked pool inside a test worker) and one
torch thread (the suite's other workers share the cores); the test
worker's environment is restored after the run."""
import os

import torch

from perfbench import run as harness

SCALE = 0.002            # 3,000 orders, about 12,000 rows
THREADS = {"shard_processes": 0}


def tiny_run(cell, seed=20240611, seconds=1.0, trace=False, root=None):
    env, threads = dict(os.environ), torch.get_num_threads()
    harness.pin_environment()
    bench = harness.load_bench(root or harness.ROOT)
    torch.set_num_threads(1)
    try:
        return harness.run_cell(bench, cell, seed, seconds, trace,
                                device="cpu", scale=SCALE, service=THREADS,
                                root=root or harness.ROOT,
                                log=lambda *a, **k: None)
    finally:
        torch.set_num_threads(threads)
        os.environ.clear()
        os.environ.update(env)
