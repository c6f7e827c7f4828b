"""Run one benchmark cell of the PyTorch port once, and print its result.

    python3 perfbench/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout.  The cell's entry in ``BENCHMARK.json`` names
its configuration and its traffic mix; everything else is found by name:

* ``perfbench/configs/<config>.json``: the deployment (its generator,
  scale, columns, sort, shards and service settings);
* ``perfbench/gen/<generator>.py``: the data generator the config names;
* ``perfbench/traffic/<traffic>.json``: the mix, read by
  ``perfbench/gen/traffic.py``;
* ``perfbench/metrics/<metric>.py``: one reader per metric of
  ``BENCHMARK.json``, each a ``read(record)`` that returns the metric's
  number from the run's record, or None when it finds nothing to read.

A run: generate the fact table from the seed; build the index with
``repro_torch.core.Dataset.from_rows`` (timed); save it as a store under
the run's temporary directory; open it with ``QueryService.from_dir(...,
mmap=True, device="cuda")`` behind ``make_server`` on a free port; build
and load the kernels and warm the HTTP path with the mix's templates; then
measure: a spawned client process (``perfbench/client.py``) sends the mix
in whole decks, starting decks for ``--seconds`` seconds; the window lasts
to the last deck's last answer.
With ``--trace 1`` the window runs under ``torch.profiler`` and the
per-layer metrics are reported instead of the end-to-end ones.  Once the
window has closed, the peak device memory is read, the service is freed,
and every answer is judged against the plain reference
(``perfbench/reference/answers.py``) over the same generated rows.

The last line of standard output is the result, a JSON object.  The run
exits non-zero, printing no result, without CUDA or with fewer cards than
the cell asks for, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# answers judged against the reference, at most; a sample drawn from the
# seed beyond it
MAX_JUDGED = 4000
WARMUP = {"select": {"count": True}}


def pin_environment() -> None:
    """Keep every cache of the run inside the checkout or the run's own
    temporary directory, and the planner on its static crossover."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    # a path that never exists: no calibrated crossover is picked up from
    # the user's cache, and nothing is calibrated or written
    os.environ["REPRO_TORCH_COST_MODEL"] = str(
        build / "perfbench" / "no-cost-model.json")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_bench(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(bench: Dict, cell: str, kind: str) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell]) and m["moves"] in names]


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


# -- the traced window -----------------------------------------------------------

class FoldBytes:
    """Counts the least bytes of every ``logical_reduce.fold`` call that
    launches, by wrapping the module's ``fold`` (the executor reaches it
    through ``kernels.ops``): its flag rows, op and width are kept, and
    reduced with ``metrics.arith.reduce_bytes`` once the window closes."""

    def __init__(self, lr):
        self.lr = lr
        self.real = lr.fold
        self.calls = []
        self.lock = threading.Lock()

    def __enter__(self):
        real, calls, lock = self.real, self.calls, self.lock

        def fold(pos, pos_flags, neg=(), neg_flags=(), op="and"):
            out = real(pos, pos_flags, neg, neg_flags, op)
            rows = len(pos) + len(neg)
            if rows > 1 and pos[0].is_cuda and pos[0].numel():
                with lock:
                    calls.append(([*pos_flags, *neg_flags], len(pos), op,
                                  pos[0].numel()))
            return out

        self.lr.fold = fold
        return self

    def __exit__(self, *exc):
        self.lr.fold = self.real

    def total(self) -> int:
        from perfbench.metrics.arith import reduce_bytes
        return sum(reduce_bytes([None if f is None else f.cpu().numpy()
                                 for f in flags], n_pos, op, cols)
                   for flags, n_pos, op, cols in self.calls)


def read_trace(path: Path, spans, t_open: float) -> Dict:
    """Device busy seconds, kernel seconds by name, the window and the
    breakdown from an exported ``torch.profiler`` trace; ``spans`` are the
    host's statement spans, ``(start, end, name)`` on the host clock, whose
    window opened at ``t_open``."""
    from perfbench.metrics import arith
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, kernel_s = [], {}
    window = None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s = ev["ts"] * 1e-6
        e = s + ev.get("dur", 0) * 1e-6
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((s, e))
            kernel_s[name] = kernel_s.get(name, 0.0) + (e - s)
        elif cat == "user_annotation" and name == "perfbench.window":
            window = (s, e)
    if window is None:
        raise RuntimeError("the trace has no window span")
    lo, hi = window
    shift = lo - t_open
    spans = [(s + shift, e + shift, name) for s, e, name in spans]
    busy = arith.union_length(device, lo, hi)
    gaps = sorted(arith.gaps(device, lo, hi), key=lambda g: g[0] - g[1])
    idle = []
    for gs, ge in gaps[:10]:
        cover = {}
        for s, e, name in spans:
            c = min(e, ge) - max(s, gs)
            if c > 0:
                cover[name] = cover.get(name, 0.0) + c
        label = max(cover, key=cover.get) if cover else "no statement"
        idle.append([label, ge - gs])
    ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "trace_window_s": hi - lo, "kernel_s": kernel_s,
            "breakdown": {"device_ops": [[n, s] for n, s in ops],
                          "idle_gaps": idle}}


def traced_statements(svc) -> List:
    """Wrap the service's statement entry in a span named after the
    statement's select, kept on the host clock, so that an idle gap of the
    device can say what the host was doing; returns the span list."""
    real, spans = svc.statement, []

    def statement(obj):
        sel = obj.get("select") if isinstance(obj, dict) else None
        kind = next(iter(sel), "?") if isinstance(sel, dict) else "?"
        by = sel.get("by") if isinstance(sel, dict) else None
        name = f"statement.{kind}" + (f".by{len(by)}" if by else "")
        t = time.perf_counter()
        try:
            return real(obj)
        finally:
            spans.append((t, time.perf_counter(), name))
    svc.statement = statement
    return spans


def log_templates(records, log) -> None:
    """On standard error: per template, queries sent, failed, and the
    smallest, median and largest latency in seconds; then every answered
    query's latency, in the order sent."""
    by = {}
    for r in records:
        by.setdefault(r["template"], []).append(r)
    for name, rs in by.items():
        lat = sorted(r["t_done"] - r["t_send"] for r in rs if r["ok"])
        log(f"template {name}: sent {len(rs)}, "
            f"failed {sum(1 for r in rs if not r['ok'])}, latency s "
            f"{[lat[0], lat[(len(lat) - 1) // 2], lat[-1]] if lat else None}",
            file=sys.stderr)
    log("latencies s " + json.dumps([r["t_done"] - r["t_send"]
                                     for r in records if r["ok"]]),
        file=sys.stderr)


# -- one run ---------------------------------------------------------------------

def run_cell(bench: Dict, cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", scale: Optional[float] = None,
             root: Path = ROOT, service: Optional[Dict] = None,
             warm: bool = True, log=print) -> Dict:
    """One run of ``cell``; returns the result object (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ``checks``, and
    with ``trace`` the ``breakdown``).  ``device="cpu"``, a small ``scale``
    and ``service`` settings over the config's drive the same run on the
    CPU (tests); ``warm=False`` skips the warm-up of the mix's templates
    (the control, whose answers alone are read)."""
    import torch
    from repro_torch.core import Dataset
    from repro_torch.kernels import logical_reduce as lr
    from repro_torch.serve.query_api import QueryService, make_server
    from perfbench.gen import traffic
    from perfbench.reference.answers import Reference

    here = root / "perfbench"
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    conf_entry = next(c for c in bench["configs"]
                      if c["name"] == entry["config"])
    with open(root / conf_entry["file"]) as f:
        conf = json.load(f)
    mix = traffic.load_mix(here / "traffic" / f"{entry['traffic']}.json")
    kind = "per_layer" if trace else "end_to_end"
    readers = {m["name"]: load_module(here / "metrics" / f"{m['name']}.py",
                                      f"perfbench_metric_{m['name']}")
               for m in cell_metrics(bench, cell, kind)}
    gen = load_module(here / "gen" / f"{conf['generator']}.py",
                      f"perfbench_gen_{conf['generator']}")
    columns = list(conf["columns"])
    cards = [int(conf["cards"][c]) for c in columns]
    sf = float(conf["scale_factor"] if scale is None else scale)
    scratch = Path(tempfile.mkdtemp(prefix="perfbench-"))
    server = svc = None
    try:
        data = gen.generate(seed, sf)
        rows, measures = data["rows"], data["measures"]
        if list(gen.COLUMNS) != columns:
            raise ValueError(f"{conf_entry['file']}: columns differ from "
                             f"the generator's")
        n_rows = len(rows)

        t = time.perf_counter()
        ds = Dataset.from_rows(
            rows, columns, sort=conf["sort"], k=int(conf["k"]), cards=cards,
            shards=int(conf["shards"]),
            measures={m: measures[m] for m in conf["measures"]},
            device=device)
        build_s = time.perf_counter() - t
        store = scratch / "store"
        ds.save(str(store))
        del ds
        gc.collect()

        t = time.perf_counter()
        svc = QueryService.from_dir(str(store), mmap=True, device=device,
                                    **{**conf["service"], **(service or {})})
        store_open_s = time.perf_counter() - t
        stats = svc.stats()
        log(f"cost model in use: {json.dumps(stats['cost_model'])}",
            file=sys.stderr)

        spans = traced_statements(svc) if trace else []
        server = make_server(svc, "127.0.0.1", 0)
        port = server.server_address[1]
        threading.Thread(target=server.serve_forever, daemon=True).start()

        # warm-up: the kernel's build and load, then the mix's own
        # templates over HTTP (parameters from another stream of the seed,
        # no query the same as one the window sends), so that the window
        # meets the service as a long-running one does:
        # every path taken once, the memoized per-bitmap structures built;
        # the result cache is emptied before the window opens
        if device != "cpu":
            one = torch.ones(1024, dtype=torch.int32, device=device)
            lr.fold([one, one], [None, None], op="and")
            torch.cuda.synchronize()
        from perfbench.client import post
        queries = traffic.sequence(mix, seed)
        n_warm = int(mix.get("warmup_queries", 0)) if warm else 0
        warm_sts = [WARMUP] + [st for q in traffic.warmup(mix, seed, queries,
                                                          n_warm)
                               for st in q["statements"]]
        for st in warm_sts:
            status, _ = post(port, json.dumps(st).encode(), 600)
            if status != 200:
                raise RuntimeError(f"warm-up statement failed: HTTP {status}")
        svc.invalidate_cache()

        plan = {"port": port, "seconds": seconds, "queries": queries,
                "clients": int(mix["clients"]),
                "deck": traffic.deck_size(mix)}
        with open(scratch / "plan.json", "w") as f:
            json.dump(plan, f)
        out_path = scratch / "records.json"
        cmd = [sys.executable, str(here / "client.py"),
               str(scratch / "plan.json"), str(out_path)]
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}

        cache_start = svc.stats()["cache"]
        launches_start = lr.launches
        setup_s = time.perf_counter() - T_START
        fold_bytes = FoldBytes(lr)
        prof = None
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device != "cpu":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            fold_bytes.__enter__()
        t_open = time.perf_counter()
        try:
            with torch.profiler.record_function("perfbench.window"):
                proc = subprocess.Popen(cmd, env=env)
                try:
                    rc = proc.wait(timeout=seconds + 240)
                finally:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
            if device != "cpu":
                torch.cuda.synchronize()
        finally:
            window_s = time.perf_counter() - t_open
            if prof is not None:
                fold_bytes.__exit__()
                prof.__exit__(None, None, None)
        if rc != 0:
            raise RuntimeError(f"the client exited with {rc}")
        launches = lr.launches - launches_start
        cache_end = svc.stats()["cache"]
        size_words = int(stats["size_words"])
        with open(out_path) as f:
            records = json.load(f)
        log_templates(records, log)

        dev = {"platform": "cpu" if device == "cpu" else "gpu",
               "kind": "cpu" if device == "cpu"
               else torch.cuda.get_device_name(0),
               "count": int(entry["chips"]),
               "memory_peak_bytes": 0 if device == "cpu"
               else int(torch.cuda.max_memory_allocated())}
        rec = {"n_rows": n_rows, "build_s": build_s,
               "warmup_statements": len(warm_sts),
               "size_words": size_words, "setup_s": setup_s,
               "store_open_s": store_open_s, "seconds": float(seconds),
               "records": records, "cache_start": cache_start,
               "cache_end": cache_end, "launches": launches,
               "queries_completed": sum(1 for r in records if r["ok"]),
               "window_s": window_s}
        result_extra = {}
        if trace:
            rec["reduce_bytes"] = fold_bytes.total()
            tr = scratch / "trace.json"
            prof.export_chrome_trace(str(tr))
            if device != "cpu":
                t_info = read_trace(tr, spans, t_open)
                rec.update(busy_s=t_info["busy_s"],
                           kernel_s=t_info["kernel_s"],
                           window_s=t_info["trace_window_s"])
                dev["busy_s"] = t_info["busy_s"]
                dev["window_s"] = t_info["trace_window_s"]
                result_extra["breakdown"] = t_info["breakdown"]
            else:
                rec.update(busy_s=0.0, kernel_s={})
            tr.unlink()
            del prof
        fold_bytes.calls.clear()

        # free the program's state before the reference runs
        server.shutdown()
        server.server_close()
        svc.close()
        server = svc = None
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()

        wrong, judged = judge(records, queries, rows, columns, conf,
                              measures, seed, device, Reference)
        failed = sum(1 for r in records if not r["ok"])
        checks = {"wrong_answers": {"value": wrong, "limit": 0},
                  "failed_queries": {"value": failed, "limit": 0},
                  "answers_judged": {"value": judged, "limit": 1}}
        for name, c in checks.items():
            side = "at least" if name == "answers_judged" else "at most"
            log(f"check {name}: {c['value']} (limit: {side} {c['limit']})",
                file=sys.stderr)
        metrics = {}
        for m in cell_metrics(bench, cell, kind):
            v = readers[m["name"]].read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        return {"correct": wrong == 0 and failed == 0 and judged > 0,
                "attempted": len(records), "failed": failed,
                "metrics": metrics, "device": dev, **result_extra,
                "checks": checks}
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        if svc is not None:
            svc.close()
        shutil.rmtree(scratch, ignore_errors=True)


def judge(records, queries, rows, columns, conf, measures, seed, device,
          Reference):
    """(wrong, judged): statements of the window's answered queries whose
    answer differs from the reference's, of those judged (all, or a sample
    of ``MAX_JUDGED`` drawn from the seed), plus the queries that failed."""
    from perfbench.gen.ssb import rng_for
    pairs = [(st, resp) for r in records if r["ok"]
             for st, resp in zip(queries[r["i"]]["statements"],
                                 r["responses"])]
    if len(pairs) > MAX_JUDGED:
        pick = rng_for(seed, 2).choice(len(pairs), MAX_JUDGED, replace=False)
        pairs = [pairs[i] for i in sorted(pick)]
    ref = Reference(rows, columns, conf["cards"],
                    {m: measures[m] for m in conf["measures"]},
                    device=device)
    wrong = sum(1 for st, resp in pairs if not ref.judge(st, resp))
    wrong += sum(1 for r in records if not r["ok"])
    return wrong, len(pairs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_environment()
    bench = load_bench()
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(entry["chips"]):
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}", file=sys.stderr)
        return 4
    checks = result.pop("checks")
    result["checks"] = {k: [v["value"], v["limit"]]
                        for k, v in checks.items()}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
