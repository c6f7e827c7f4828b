"""Per-op traffic and FLOPs of one dry-run cell: what dominates?

    PYTHONPATH=src python -m repro_torch.launch.breakdown --arch qwen2-0.5b \\
        --shape train_4k --mesh multi --variant opt --top 15

Traces the cell's step on ``meta`` as ``launch/dryrun.py`` does and ranks
the counter's records, (aten op, innermost function of the package), by
bytes and by FLOPs, per device (the global step divided evenly over the
mesh, as the dry-run's ``even_split``).  A hand-written kernel's launch is
ranked under the kernel's name.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="multi")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    args.tag = "breakdown"

    from repro_torch.launch import dryrun as dr
    traces: dict = {}
    rec = dr.run_cell(args.arch, args.shape, args.mesh, args, traces)
    if rec["status"] != "ok":
        raise SystemExit(f"{args.arch} {args.shape}: {rec['status']} "
                         f"({rec.get('reason', '')})")
    counter, _ = traces[(args.arch, args.shape)]
    n = rec["n_devices"]
    for by in ("bytes", "flops"):
        print(f"\n==== TOP {by.upper()} ====")
        for v, op, where in counter.top(args.top, by):
            print(f"{v / n:.3e}  {op:<12} {where}")


if __name__ == "__main__":
    main()
