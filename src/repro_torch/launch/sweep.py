"""Resumable runner of the full (arch × shape × mesh) dry-run sweep.

Cells are ordered cheapest-first (decode < prefill < train; small archs
first) so results accumulate early.  Existing JSONs are skipped, making the
sweep restartable after interruption:

    PYTHONPATH=src python -m repro_torch.launch.sweep --mesh both

Each cell is ``launch/dryrun.py``'s ``run_cell`` on ``meta`` (no card
needed); a cell's two meshes share one trace.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

# rough cost rank: params ~ layers * d_model^2 scaled
_ARCH_COST = {
    "qwen2-0.5b": 1, "whisper-small": 1, "mamba2-780m": 2, "zamba2-1.2b": 3,
    "gemma2-9b": 30, "codeqwen1.5-7b": 25, "internvl2-26b": 60,
    "command-r-35b": 90, "llama4-maverick-400b-a17b": 150, "arctic-480b": 200,
}
_KIND_COST = {"decode": 1, "prefill": 3, "train": 10}


def main(argv=None):
    from repro_torch.launch.dryrun import DEFAULT_OUT
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out-dir", default=DEFAULT_OUT)
    ap.add_argument("--only-arch", default=None)
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.launch.dryrun import error_record, run_cell

    class A:  # default knobs (baseline variant)
        tag = "baseline"
        no_remat = False
        no_act_constraints = False
        capacity_factor = None

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = []
    for a in ARCHS:
        if args.only_arch and a != args.only_arch:
            continue
        for s, sc in SHAPES.items():
            for m in meshes:
                cost = _ARCH_COST.get(a, 50) * _KIND_COST.get(sc.kind, 5)
                cells.append((cost, a, s, m))
    cells.sort()

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    t_start = time.time()
    done = failed = skipped = 0
    traces: dict = {}
    for cost, a, s, m in cells:
        path = out_dir / f"{a}__{s}__{m}.json"
        if path.exists() and json.loads(path.read_text()).get("status") in (
                "ok", "skipped"):
            skipped += 1
            continue
        t0 = time.time()
        try:
            rec = run_cell(a, s, m, A, traces)
            done += 1
        except Exception as e:  # noqa: BLE001 — record and go on
            traceback.print_exc()
            rec = error_record(a, s, m, "baseline", e)
            failed += 1
        path.write_text(json.dumps(rec, indent=1))
        print(f"[sweep] {a}/{s}/{m} -> {rec['status']} "
              f"({time.time()-t0:.0f}s; total {time.time()-t_start:.0f}s; "
              f"done={done} failed={failed} cached={skipped})", flush=True)
    print(f"[sweep] COMPLETE done={done} failed={failed} cached={skipped} "
          f"in {time.time()-t_start:.0f}s")


if __name__ == "__main__":
    main()
