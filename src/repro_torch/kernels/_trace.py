"""The hand-written kernels' launches, reported to the cost counters that
are counting.

A launch goes through ``ctypes``, which the torch dispatcher does not see,
so a counter of aten ops (``launch/op_analysis.OpCounter``) would miss it.
Each wrapper calls ``launched`` once a launch is enqueued; an active counter
costs it as one op named after the kernel, its operand and result bytes
and no FLOPs, as the reference's HLO parser costs a custom call.  The
report changes nothing that the wrapper launches.

Scopes (below) let a counter keep a region's ops apart from the rest; they
change nothing that runs either.

Spans and counters (last section) time and count the layers of the served
query path on the host: the HTTP request, the statement, the per-shard
plan and task, the filter, each composite node by its backend, and the
group-by's catalog and cells.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import Dict, Iterable, List, NamedTuple, Optional

import torch
from torch.utils._pytree import tree_flatten

# the counters that are counting, innermost last (OpCounter enters and
# leaves this list)
counters: list = []


def launched(name: str, operands: Iterable[torch.Tensor],
             results: Iterable[torch.Tensor]) -> None:
    for counter in list(counters):
        counter.kernel(name, list(operands), list(results))


# -- scopes ------------------------------------------------------------------
# A scope names a region whose ops a counter keeps apart from the rest: the
# expert-parallel MoE's body is one device's work, where the rest of a
# dry-run's trace is the global step.  In the forward (and in a
# checkpoint's recomputation) the scope is the innermost ``scope`` block on
# this thread; in the backward, the autograd node that the engine is
# running carries it, tagged by ``scoped`` when the forward built it.

_SCOPE_KEY = "repro_torch.scope"
_local = threading.local()


@contextlib.contextmanager
def scope(name: str):
    """Ops dispatched inside the block are counted under ``name``."""
    stack = _local.__dict__.setdefault("stack", [])
    stack.append(name)
    try:
        yield
    finally:
        stack.pop()


def current_scope() -> Optional[str]:
    """The scope of an op dispatched now: the innermost ``scope`` block;
    else, in the backward (grad mode off), the scope that tags the
    autograd node being run; else None."""
    stack = _local.__dict__.get("stack")
    if stack:
        return stack[-1]
    if torch.is_grad_enabled():     # a forward, or a recomputation
        return None
    node = torch._C._current_autograd_node()
    return None if node is None else node.metadata.get(_SCOPE_KEY)


def _mark_graph(name: str, outputs, inputs) -> None:
    """Tag with ``name`` every autograd node between ``outputs`` and
    ``inputs`` (the inputs' own nodes and leaves' accumulators excluded)."""
    stop = {t.grad_fn for t in inputs if t.grad_fn is not None}
    todo = [t.grad_fn for t in outputs if t.grad_fn is not None]
    seen = set()
    while todo:
        node = todo.pop()
        if node is None or node in seen or node in stop:
            continue
        seen.add(node)
        if not node.next_functions and hasattr(node, "variable"):
            continue                # a leaf's AccumulateGrad
        node.metadata[_SCOPE_KEY] = name
        todo.extend(f for f, _ in node.next_functions)


def scoped(name: str):
    """Decorator: the function's ops count under ``name`` in the forward
    and, while a counter is counting, in the backward too."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with scope(name):
                out = fn(*args, **kwargs)
            if counters and torch.is_grad_enabled():
                _mark_graph(name, _flat_tensors(out),
                            _flat_tensors((args, kwargs)))
            return out
        return inner
    return wrap


def _flat_tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


# -- spans and counters -------------------------------------------------------
# A span times one step of the served path on the host's monotonic clock
# (``time.perf_counter_ns``).  Spans are off by default: ``span`` then costs
# one flag test and returns a shared null context, records nothing and
# allocates nothing of its own.  ``recording()`` turns them on and keeps
# them in memory with one anchor pair (``time.time_ns()``,
# ``time.perf_counter_ns()``) taken at its start, which places each span on
# the wall clock that an exported ``torch.profiler`` trace is stamped with
# (its ``ts`` plus ``baseTimeNanoseconds``).  A span's parent is the span
# open on its thread when it opened; ``carry`` hands that across a thread
# pool.  Its request is the id of the root span it descends from (the HTTP
# request, where there is one).
#
# Counters are always on: one process-wide dict under one lock, bumped at
# most once per node, per shard task or per statement.  While a recording
# is on, each bump is also kept with its time and request, so that a
# reader can take a window's share of a counter.

class Span(NamedTuple):
    name: str
    start: int          # perf_counter_ns
    end: int
    thread: int         # threading.get_ident(); a trace's CUDA runtime
                        # calls carry its low 32 bits as their ``tid``
    id: int
    parent: Optional[int]
    request: int
    attrs: Dict


class Bump(NamedTuple):
    name: str
    t: int              # perf_counter_ns
    n: float
    request: Optional[int]


class Recording(list):
    """The spans of one recording, in the order they ended; ``bumps``
    holds the counter bumps made while it was on, ``anchor`` the pair
    (``time.time_ns()``, ``time.perf_counter_ns()``) read at its start."""

    def __init__(self):
        super().__init__()
        self.bumps: List[Bump] = []
        self.anchor = (time.time_ns(), time.perf_counter_ns())


class _Null:
    """The context of a span that is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_on = False
_recording: Optional[Recording] = None
_NULL = _Null()
_ids = itertools.count(1)
_context = threading.local()
_counts: Dict[str, float] = {}
_count_lock = threading.Lock()


def _stack() -> list:
    """This thread's open spans, as (id, request) pairs, innermost last."""
    try:
        return _context.stack
    except AttributeError:
        _context.stack = []
        return _context.stack


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "request", "start")

    def __init__(self, name: str, attrs: Dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        if stack:
            self.parent, self.request = stack[-1]
        else:
            self.parent, self.request = None, self.id
        stack.append((self.id, self.request))
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _stack().pop()
        rec = _recording
        if rec is not None:
            rec.append(Span(self.name, self.start, end,
                            threading.get_ident(), self.id, self.parent,
                            self.request, self.attrs))
        return False


def span(name: str, **attrs):
    """A context manager that times the block as the span ``name``."""
    if not _on:
        return _NULL
    return _Span(name, attrs)


@contextlib.contextmanager
def recording():
    """Turn spans on for the block; yields the ``Recording`` it fills.  One
    recording at a time."""
    global _on, _recording
    if _recording is not None:
        raise RuntimeError("spans are already being recorded")
    rec = Recording()
    _recording = rec
    _on = True
    try:
        yield rec
    finally:
        _on = False
        _recording = None


def carry(fn):
    """``fn`` to be run on another thread, under the span open here: its
    spans take that span as parent and its request.  Returns ``fn`` itself
    while spans are off or no span is open."""
    if not _on:
        return fn
    stack = _stack()
    if not stack:
        return fn
    ctx = stack[-1]

    @functools.wraps(fn)
    def carried(*args, **kwargs):
        st = _stack()
        st.append(ctx)
        try:
            return fn(*args, **kwargs)
        finally:
            st.pop()
    return carried


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the process-wide counter ``name``."""
    with _count_lock:
        _counts[name] = _counts.get(name, 0) + n
    rec = _recording
    if rec is not None:
        stack = _stack()
        rec.bumps.append(Bump(name, time.perf_counter_ns(), n,
                              stack[-1][1] if stack else None))


def counter_values() -> Dict[str, float]:
    """A copy of every counter of ``count``."""
    with _count_lock:
        return dict(_counts)


def self_ns(spans: Iterable[Span], lo: Optional[int] = None,
            hi: Optional[int] = None) -> Dict[int, int]:
    """Each span's self time in nanoseconds, by id, within [lo, hi] when
    given: its length less the union of its children's, children that ran
    on other threads included."""
    spans = list(spans)
    lo = min((s.start for s in spans), default=0) if lo is None else lo
    hi = max((s.end for s in spans), default=0) if hi is None else hi
    kids: Dict[int, list] = {}
    for s in spans:
        if s.parent is not None:
            kids.setdefault(s.parent, []).append((s.start, s.end))
    out = {}
    for s in spans:
        a, b = max(s.start, lo), min(s.end, hi)
        if b <= a:
            out[s.id] = 0
            continue
        covered, t = 0, a
        for cs, ce in sorted(kids.get(s.id, ())):
            cs, ce = max(cs, t), min(ce, b)
            if ce > cs:
                covered += ce - cs
                t = ce
        out[s.id] = (b - a) - covered
    return out
