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
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Iterable, Optional

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
