"""The control of ``correct``: whole runs of a cell with the program's
measure sums computed in float32, the precision below the configuration's
int64, judged by the run's own comparison; each has to come out not
correct.

    python3 perfbench/control.py --workload CELL --seeds 1 2 3 --seconds S

``float32_sums`` swaps the sums of ``repro_torch.core.measures`` (the
scalar sums over a filter's intervals, and the prefix sums that every
group's sum is taken from) for float32 ones, their results cast back to
the measure's int64; the rest of the run (generation, build, store,
service over HTTP, the window's whole decks, the reference's judgement) is
``perfbench.run.run_cell`` as the benchmark runs it, less the warm-up of
the mix's templates, which changes no answer.  Prints one JSON line
per seed with ``correct`` and the checks beside their limits.  The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@contextlib.contextmanager
def float32_sums():
    from repro_torch.core import measures
    real_prefix, real_reduce = measures.prefix_sums, measures.reduce_intervals

    def prefix_sums(fvals):
        return real_prefix(fvals.astype(np.float32)).astype(fvals.dtype)

    def reduce_intervals(values, starts, ends):
        s, c, lo, hi = real_reduce(values.astype(np.float32), starts, ends)
        if values.dtype.kind == "f":
            return s, c, lo, hi
        return (int(s), c, None if lo is None else int(lo),
                None if hi is None else int(hi))

    measures.prefix_sums = prefix_sums
    measures.reduce_intervals = reduce_intervals
    try:
        yield
    finally:
        measures.prefix_sums = real_prefix
        measures.reduce_intervals = real_reduce


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench.run import load_bench, pin_environment, run_cell
    pin_environment()
    bench = load_bench()
    for seed in args.seeds:
        t = time.perf_counter()
        with float32_sums():
            out = run_cell(bench, args.workload, seed, args.seconds, False,
                           warm=False)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checks": out["checks"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
