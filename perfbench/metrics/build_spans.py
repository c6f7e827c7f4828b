"""The program's spans and counter bumps of the index build
(``Dataset.from_rows``) in a traced run, for the per-layer metrics that
read them.

The build runs before the window and outside any HTTP request, so
``spans.window`` keeps none of it.  A reader of the build calls
``start()`` when it is loaded: it starts the program's recording as
``spans.start`` does, and holds on to it.  The first ``build(rec)`` keeps
the build's part of it in the record, under ``"build"``, and ends the
recording through ``spans.window``.  The build's part: the spans whose
request is a span of one of the build's steps (``STEPS``) opened at top
level, each step's self seconds summed over its spans, and the counters
bumped under them, summed by name.  A program whose build has no such
spans gives None, and its readers return None.
"""
from __future__ import annotations

from typing import Dict, Optional

from perfbench.metrics import spans

STEPS = ("build.sort", "build.encode", "build.index", "build.shard")
_held = {"rec": None}


def start() -> None:
    """Start the program's recording, and hold it for ``build``."""
    spans.start()
    _held["rec"] = spans.live()


def select(recording) -> Optional[Dict]:
    """The build's part of ``recording``: ``{"seconds": {step: self
    seconds}, "counts": {counter: sum}}``; None without build spans."""
    from repro_torch.kernels._trace import self_ns
    roots = {s.id for s in recording
             if s.parent is None and s.name in STEPS}
    ss = [s for s in recording if s.request in roots]
    if not ss:
        return None
    own = self_ns(ss)
    seconds = {step: 1e-9 * sum(own[s.id] for s in ss if s.name == step)
               for step in STEPS}
    counts: Dict[str, float] = {}
    for b in recording.bumps:
        if b.request in roots:
            counts[b.name] = counts.get(b.name, 0) + b.n
    return {"seconds": seconds, "counts": counts}


def build(rec: Dict) -> Optional[Dict]:
    if "build" not in rec:
        recording, _held["rec"] = _held["rec"], None
        spans.window(rec)
        rec["build"] = None if recording is None else select(recording)
    return rec["build"]
