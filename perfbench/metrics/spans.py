"""The program's own spans and counter bumps (``repro_torch.kernels._trace``)
in a traced run, for the per-layer metrics that read them.

The harness loads every reader of a traced run before it generates the
data, so each reader of spans calls ``start()`` when it is loaded: the
program records from then on, through the build, the warm-up and the
window.  The first ``window(rec)`` ends the recording, keeps the window's
part of it in the record, under ``"program"``, for the other readers, and
prints on standard error one line per span name (calls, total and self
seconds) and the spans per statement.  A record that already holds
``"program"`` is read as it is.

The window's part: the harness sends nothing over HTTP after the window,
and the client sends one request per statement, so the window's requests
are the last ``K`` ``http.request`` spans, ``K`` the statements of the
client's records.  A span or a counter bump belongs to the window when its
request does.  A program without spans records nothing, and every reader
then returns None.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional

from perfbench.metrics.arith import union_length

STATEMENTS = "statements/"
_live = {"cm": None, "rec": None}


def start() -> None:
    """Start the program's recording, unless it runs already or the
    program has none."""
    if _live["cm"] is not None:
        return
    try:
        from repro_torch.kernels import _trace
    except ImportError:
        return
    if getattr(_trace, "recording", None) is None or \
            getattr(_trace, "_recording", None) is not None:
        return
    cm = _trace.recording()
    _live.update(cm=cm, rec=cm.__enter__())


def live():
    """The recording under way, or None."""
    return _live["rec"]


def _finish():
    cm, rec = _live["cm"], _live["rec"]
    _live.update(cm=None, rec=None)
    if cm is not None:
        cm.__exit__(None, None, None)
    return rec


def select(recording, records) -> Optional[Dict]:
    """The window's part of ``recording``: its spans and bumps as dicts,
    and the anchor; None when it holds fewer requests than the window."""
    k = sum(len(r["responses"]) for r in records)
    roots = sorted((s for s in recording if s.name == "http.request"),
                   key=lambda s: s.start)
    if k == 0 or len(roots) < k:
        return None
    reqs = {s.id for s in roots[-k:]}
    return {"spans": [s._asdict() for s in recording if s.request in reqs],
            "bumps": [b._asdict() for b in recording.bumps
                      if b.request in reqs],
            "anchor": list(recording.anchor), "statements": k}


def window(rec: Dict, log=print) -> Optional[Dict]:
    if "program" not in rec:
        recording = _finish()
        rec["program"] = None if recording is None else \
            select(recording, rec["records"])
        if rec["program"] is not None:
            summary(rec["program"], recording, log)
    return rec["program"]


def summary(prog: Dict, recording, log=print) -> None:
    """On standard error: per span name of the window, calls, total and
    self seconds; then the spans per statement."""
    from repro_torch.kernels._trace import self_ns
    ids = {s["id"] for s in prog["spans"]}
    own = self_ns([s for s in recording if s.id in ids])
    by: Dict[str, List[float]] = {}
    for s in prog["spans"]:
        row = by.setdefault(s["name"], [0, 0.0, 0.0])
        row[0] += 1
        row[1] += (s["end"] - s["start"]) * 1e-9
        row[2] += own[s["id"]] * 1e-9
    for name, (calls, total, mine) in sorted(by.items(),
                                             key=lambda kv: -kv[1][2]):
        log(f"span {name}: calls {calls}, total s {total}, self s {mine}",
            file=sys.stderr)
    log(f"spans per statement: {len(prog['spans']) / prog['statements']}",
        file=sys.stderr)


def spans(rec: Dict, name: str) -> List[Dict]:
    prog = window(rec)
    return [] if prog is None else [s for s in prog["spans"]
                                     if s["name"] == name]


def bumps(rec: Dict, keep) -> Optional[float]:
    """The window's sum of the counters whose names ``keep(name)``
    accepts; None without a recording."""
    prog = window(rec)
    if prog is None:
        return None
    return sum(b["n"] for b in prog["bumps"] if keep(b["name"]))


def statement_seconds(name: str) -> bool:
    """The counters of the service's time in its statements, one a kind
    (``statements/<kind>/seconds``)."""
    return name.startswith(STATEMENTS) and name.endswith("/seconds")


def seconds(ss: List[Dict]) -> float:
    return sum(s["end"] - s["start"] for s in ss) * 1e-9


def union_seconds(ss: List[Dict]) -> float:
    return union_length((s["start"], s["end"]) for s in ss) * 1e-9
