"""One traced run of a cell, as ``perfbench/run.py --trace 1`` makes it,
with the device's ten longest idle gaps named by the program's own spans,
and the spans' clock checked against the trace's.

    python3 perfbench/trace_gaps.py --workload CELL --seed N --seconds S

from the root of a checkout.  A gap is named ``statement.<kind>/<span>``:
the program span with the most self time in the gap (its time in the gap
less its children's, children on other threads included) and the kind of
the statement whose request it served.  Spans are placed on the trace's
clock by the recording's anchor pair and the trace's
``baseTimeNanoseconds``.  The clock check (``clock_check``): of the
window's ``logical_reduce`` kernels, the share that start on the device
after the start of a ``kernel.launch`` span and before the end of its
``exec.kernel_node``, and the misses, on the anchor's mapping and on it
fitted to the trace's host clock; and each kernel against its own launch,
found through its CUDA runtime call.

The result line is run.py's, with the breakdown's ``idle_gaps`` named so
and a ``clock_check`` beside them; both are also printed on standard
error.  A program without spans leaves run.py's names.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict, List, Tuple

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from perfbench import run as harness  # noqa: E402
from perfbench.metrics import arith, spans  # noqa: E402


def device_window(events) -> Tuple[List[Tuple[float, float]],
                                   Tuple[float, float]]:
    """The device intervals and the window, in trace seconds, by
    ``read_trace``'s rules."""
    device, window = [], None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        s = ev["ts"] * 1e-6
        e = s + ev.get("dur", 0) * 1e-6
        if ev.get("cat", "") in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((s, e))
        elif ev.get("cat") == "user_annotation" and \
                ev.get("name") == "perfbench.window":
            window = (s, e)
    return device, window


class Clock:
    """perf_counter_ns readings of a recording <-> trace seconds: the
    anchor pair and the trace's base, plus a linear correction ``a + b (t
    - t0)`` (seconds) fitted to the trace's own host clock, which drifts
    from the host's over a long window."""

    def __init__(self, anchor, base_ns: int, a: float = 0.0, b: float = 0.0,
                 t0: float = 0.0):
        self.wall, self.perf = anchor
        self.base = base_ns
        self.a, self.b, self.t0 = a, b, t0

    def trace_s(self, t: int) -> float:
        raw = (self.wall + (t - self.perf) - self.base) * 1e-9
        return raw + self.a + self.b * (raw - self.t0)

    def perf_ns(self, s: float) -> int:
        raw = (s - self.a + self.b * self.t0) / (1.0 + self.b)
        return int(round(raw * 1e9)) + self.base - self.wall + self.perf

    def fitted(self, pairs: List[Tuple[int, float]], t0: float) -> "Clock":
        """This clock corrected by a least-squares line through ``pairs``
        of (perf_counter_ns, trace seconds) of the same instants."""
        raw = Clock((self.wall, self.perf), self.base)
        xs = [raw.trace_s(t) - t0 for t, _ in pairs]
        es = [y - raw.trace_s(t) for t, y in pairs]
        mx, me = sum(xs) / len(xs), sum(es) / len(es)
        var = sum((x - mx) ** 2 for x in xs)
        b = sum((x - mx) * (e - me) for x, e in zip(xs, es)) / var \
            if var > 0 else 0.0
        return Clock((self.wall, self.perf), self.base, me - b * mx, b, t0)


def name_gaps(gaps, program, clock: Clock) -> List[List]:
    """``[name, seconds]`` of each gap (trace seconds): the span with the
    most self time in it, as ``statement.<kind>/<span>``."""
    from repro_torch.kernels._trace import self_ns
    kinds = {s.request: s.attrs.get("kind") for s in program
             if s.name == "service.statement"}
    out = []
    for gs, ge in gaps:
        lo, hi = clock.perf_ns(gs), clock.perf_ns(ge)
        inside = [s for s in program if s.end > lo and s.start < hi]
        own = self_ns(inside, lo, hi)
        best = max(inside, key=lambda s: own[s.id], default=None)
        if best is None or own[best.id] <= 0:
            label = "no span"
        elif kinds.get(best.request):
            label = f"statement.{kinds[best.request]}/{best.name}"
        else:
            label = best.name
        out.append([label, ge - gs])
    return out


def _placed(starts, program, clock: Clock) -> Dict:
    """Of the device ``starts`` (trace seconds), the share that fall
    after the start of some ``kernel.launch`` span and before the end of
    its ``exec.kernel_node``, and the misses as [seconds after the first
    start, signed ms: before the nearest launch below 0, after its node
    above 0]."""
    nodes = {s.id: s for s in program if s.name == "exec.kernel_node"}
    ivs = [(clock.trace_s(s.start), clock.trace_s(nodes[s.parent].end))
           for s in program
           if s.name == "kernel.launch" and s.parent in nodes]
    inside, misses = 0, []
    for ks in starts:
        if any(a <= ks <= b for a, b in ivs):
            inside += 1
        elif ivs:
            miss = min((ks - a if ks < a else ks - b for a, b in ivs),
                       key=abs)
            misses.append([ks - starts[0], 1e3 * miss])
    return {"share_inside": inside / len(starts) if starts else None,
            "max_miss_ms": max((abs(m) for _, m in misses), default=0.0),
            "misses": misses[:10]}


def _containing(spans, h: float, clock: Clock):
    """The span of ``spans`` whose interval holds trace second ``h``,
    else None."""
    return next((s for s in spans
                 if clock.trace_s(s.start) <= h <= clock.trace_s(s.end)),
                None)


def clock_check(events, program, clock: Clock, window) -> Dict:
    """Where the window's ``logical_reduce`` kernels start against the
    program's spans.  ``share_inside`` and the misses: after the start of
    some ``kernel.launch`` span and before the end of its
    ``exec.kernel_node``, on the anchor's clock and (``_fitted``) on it
    fitted to the trace's host clock by the runtime calls of the window's
    device-to-host copies, each issued inside a ``kernel.download`` span
    of its thread.  ``own``: each kernel against its own launch, the
    ``kernel.launch`` span of the launching thread (the runtime call's
    ``tid``) that holds the runtime call (matched by ``correlation``):
    the share so matched, the share inside that launch's node, and the
    largest delay from the launch span's start to the kernel."""
    calls = {ev.get("args", {}).get("correlation"): ev for ev in events
             if ev.get("ph") == "X" and ev.get("cat") == "cuda_runtime"}
    device = [ev for ev in events if ev.get("ph") == "X"
              and window[0] <= ev["ts"] * 1e-6 <= window[1]]
    kernels = sorted((ev for ev in device if ev.get("cat") == "kernel"
                      and "logical_reduce" in ev.get("name", "")),
                     key=lambda ev: ev["ts"])
    starts = [ev["ts"] * 1e-6 for ev in kernels]
    out = {"kernels": len(kernels),
           "launch_spans": sum(s.name == "kernel.launch" for s in program)}
    out.update(_placed(starts, program, clock))

    # a runtime call's ``tid`` is the low 32 bits of its thread's ident
    by_thread: Dict[int, Dict[str, list]] = {}
    for s in program:
        by_thread.setdefault(s.thread & 0xFFFFFFFF, {}).setdefault(
            s.name, []).append(s)

    def call_of(ev):
        call = calls.get(ev.get("args", {}).get("correlation"))
        if call is None or not isinstance(call.get("tid"), int):
            return None, {}
        # the trace may write those 32 bits signed
        mine = by_thread.get(call["tid"] & 0xFFFFFFFF)
        return (None, {}) if mine is None else (call["ts"] * 1e-6, mine)

    nodes = {s.id: s for s in program if s.name == "exec.kernel_node"}
    matched, inside, lag = 0, 0, 0.0
    for ev, ks in zip(kernels, starts):
        h, mine = call_of(ev)
        launch = None if h is None else \
            _containing(mine.get("kernel.launch", ()), h, clock)
        if launch is None or launch.parent not in nodes:
            continue
        matched += 1
        a = clock.trace_s(launch.start)
        if a <= ks <= clock.trace_s(nodes[launch.parent].end):
            inside += 1
            lag = max(lag, ks - a)
    if kernels:
        out["own"] = {"matched": matched / len(kernels),
                      "share_inside": inside / matched if matched else None,
                      "max_launch_to_kernel_ms": 1e3 * lag}

    pairs = []
    for ev in device:
        if ev.get("cat") != "gpu_memcpy" or "DtoH" not in ev.get("name", ""):
            continue
        h, mine = call_of(ev)
        down = None if h is None else min(
            mine.get("kernel.download", ()), default=None,
            key=lambda s: abs(clock.trace_s(s.start) - h))
        if down is not None:
            pairs.append((down.start, h))
    if len(pairs) >= 2:
        fit = clock.fitted(pairs, window[0])
        out["drift"] = {"pairs": len(pairs), "offset_ms": 1e3 * fit.a,
                        "ppm": 1e6 * fit.b}
        placed = _placed(starts, program, fit)
        out.update({f"{k}_fitted": v for k, v in placed.items()})
    return out


def main(argv=None) -> int:
    real = harness.read_trace

    def read_trace(path, statement_spans, t_open):
        out = real(path, statement_spans, t_open)
        rec = spans.live()
        if rec is None:
            return out
        with open(path) as f:
            trace = json.load(f)
        events = trace["traceEvents"]
        clock = Clock(rec.anchor, int(trace.get("baseTimeNanoseconds", 0)))
        program = list(rec)
        device, window = device_window(events)
        gaps = sorted(arith.gaps(device, *window),
                      key=lambda g: g[0] - g[1])[:10]
        named = name_gaps(gaps, program, clock)
        check = clock_check(events, program, clock, window)
        # the window's annotation opens just after ``t_open`` was read
        check["window_open_offset_ms"] = 1e3 * (
            window[0] - clock.trace_s(int(t_open * 1e9)))
        out["breakdown"]["idle_gaps"] = named
        out["breakdown"]["clock_check"] = check
        print(f"idle gaps by program span: {json.dumps(named)}",
              file=sys.stderr)
        print(f"clock check: {json.dumps(check)}", file=sys.stderr)
        return out

    harness.read_trace = read_trace
    args = list(sys.argv[1:] if argv is None else argv)
    return harness.main(args + ["--trace", "1"])


if __name__ == "__main__":
    sys.exit(main())
