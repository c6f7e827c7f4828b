"""Op-level cost counter: the port's counterpart of the reference's
trip-count-aware HLO roofline terms (``repro/launch/hlo_analysis.py``).

The port has no HLO.  ``OpCounter`` is a ``TorchDispatchMode``: every aten
op that a step dispatches passes through it, on any device, ``meta``
included, and it costs each op as the reference's parser costs an HLO
instruction:

  * ``mm``, ``addmm``, ``bmm`` and ``baddbmm`` (which ``matmul`` and
    ``einsum`` decompose to) exactly: 2 x output elements x the contracted
    size; ``convolution`` as 2 x output elements x its window (the weight's
    elements per output channel), and ``convolution_backward`` the same for
    each of the input and weight gradients it computes.  These are the
    ``matmul_flops``;
  * every other compute op at 1 FLOP an output element, the reference's
    proxy for a fusion; views, allocations and data movement (casts,
    copies, gathers, concatenation, padding) at none;
  * bytes as the sum of operand and result bytes of every op that moves
    data: an op whose results only alias its inputs without writing them
    (a view, a reshape, ``detach``, ``expand``, ``as_strided``; the
    schema's alias information says so) and an allocation count none,
    as the reference's ``_SKIP_BYTES_OPS`` count none.  An op that writes
    into an input (``copy_``, ``add_``) counts it as its result.

The backward is counted too, recomputation included: the dispatch mode is
thread-local state that the autograd engine carries to the thread it runs
the backward on.  A step's live bytes are followed storage by storage: a
storage is live from the op that makes it (or, for an argument, from
``track``) until the last tensor on it is freed, which for a tensor the
autograd graph saved is when the graph lets it go.  ``peak_bytes`` is the
most that was live at once.

Hand-written kernels launch through ``ctypes``, out of the dispatcher's
sight; their wrappers report each launch (``kernels/_trace.py``), and the
counter costs it as one op named after the kernel with its operand and
result bytes and 0 FLOPs, as the parser costs a custom call.

One card runs no collective, so ``collectives`` and ``collective_counts``
are empty; ``link_bytes`` is the reference's model of link traffic, kept
for a counter that sees them.
"""
from __future__ import annotations

import math
import os
import sys
import threading
import weakref
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import _trace

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

aten = torch.ops.aten
_MATMUL = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm}
_CONV = {aten.convolution, aten.convolution_backward}
_MATMUL_NAMES = {p.__name__ for p in _MATMUL | _CONV}
# allocations: no data moves, no arithmetic
_ALLOC = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
          aten.new_empty_strided}
# shares its input's storage although its schema does not say so
_VIEW_LIKE = {aten._unsafe_view}
# data movement: bytes, no FLOPs
_MOVE = {aten._to_copy, aten.copy_, aten.clone, aten.cat, aten.stack,
         aten.index, aten.index_select, aten.gather, aten.embedding,
         aten.constant_pad_nd, aten.slice_scatter, aten.select_scatter,
         aten.fill_, aten.zero_, aten.repeat, aten.scalar_tensor,
         aten.arange, aten.full, aten.zeros, aten.ones}

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SKIP_FRAMES = (os.path.abspath(__file__), os.path.abspath(_trace.__file__))


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(ts: Iterable[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _is_view(func) -> bool:
    """True when every result of ``func`` aliases an input that it does not
    write (its schema's alias annotations)."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def matmul_flops(func, args, out) -> float:
    """The exact FLOPs of a product or convolution op (0 for any other)."""
    packet = func.overloadpacket
    if packet in (aten.mm, aten.bmm):
        return 2.0 * out.numel() * args[0].shape[-1]
    if packet in (aten.addmm, aten.baddbmm):
        return 2.0 * out.numel() * args[1].shape[-1]
    if packet is aten.convolution:
        return 2.0 * out.numel() * math.prod(args[1].shape[1:])
    if packet is aten.convolution_backward:
        grad_out, weight, mask = args[0], args[2], args[10]
        return 2.0 * grad_out.numel() * math.prod(weight.shape[1:]) \
            * sum(bool(m) for m in mask[:2])
    return 0.0


class OpCounter(TorchDispatchMode):
    """Counts the FLOPs, bytes and peak live bytes of what runs inside
    ``with OpCounter() as c:``.  Call ``track`` on the step's arguments
    first, so that they count as live from the start."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.matmul_flops = 0.0
        self.bytes = 0.0
        self.n_ops = 0
        # (op, innermost repro_torch function) -> [count, flops, bytes]
        self.records: Dict[Tuple[str, str], List[float]] = defaultdict(
            lambda: [0, 0.0, 0.0])
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages: Dict[int, List[int]] = {}   # key -> [nbytes, refs]
        self._seen: Dict[int, int] = {}             # id(tensor) -> key
        self._lock = threading.RLock()
        self._where_cache: Dict[object, str] = {}

    # -- live bytes ------------------------------------------------------
    def track(self, tensors) -> None:
        """Count ``tensors`` (any nesting of dicts and lists) as live until
        they are freed."""
        with self._lock:
            for t in _tensors(tensors):
                self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        if id(t) in self._seen:
            return
        storage = t.untyped_storage()
        key = storage._cdata
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [storage.nbytes(), 0]
            self.live_bytes += entry[0]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        entry[1] += 1
        self._seen[id(t)] = key
        weakref.finalize(t, self._drop, id(t), key)

    def _drop(self, tid: int, key: int) -> None:
        with self._lock:
            if self._seen.get(tid) == key:
                del self._seen[tid]
            entry = self._storages.get(key)
            if entry is None:
                return
            entry[1] -= 1
            if entry[1] == 0:
                del self._storages[key]
                self.live_bytes -= entry[0]

    # -- attribution -----------------------------------------------------
    def _where(self) -> str:
        """The innermost function of the package on the caller's stack,
        outside this counter and the launch reports."""
        f = sys._getframe(2)
        while f is not None:
            code = f.f_code
            label = self._where_cache.get(code)
            if label is None:
                fn = os.path.abspath(code.co_filename)
                if fn.startswith(_PKG) and not fn.startswith(_SKIP_FRAMES):
                    mod = os.path.relpath(fn, _PKG)[:-3].replace(os.sep, ".")
                    label = f"{mod}.{code.co_name}"
                else:
                    label = ""
                self._where_cache[code] = label
            if label:
                return label
            f = f.f_back
        return "(autograd)"

    def _record(self, op: str, flops: float, mm_flops: float,
                n_bytes: float) -> None:
        self.n_ops += 1
        self.flops += flops
        self.matmul_flops += mm_flops
        self.bytes += n_bytes
        rec = self.records[(op, self._where())]
        rec[0] += 1
        rec[1] += flops
        rec[2] += n_bytes

    # -- the dispatch mode -------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        with self._lock:
            ins = _tensors((args, kwargs))
            outs = _tensors(out)
            for t in ins:
                self._track(t)
            for t in outs:
                self._track(t)
            if packet in _ALLOC:
                n_bytes, flops, mm = 0.0, 0.0, 0.0
            elif packet in _VIEW_LIKE or _is_view(func):
                return out
            else:
                n_bytes = float(_nbytes(ins) + _nbytes(outs))
                if packet in _MATMUL or packet in _CONV:
                    mm = flops = matmul_flops(func, args, out)
                elif packet in _MOVE:
                    mm = flops = 0.0
                else:
                    mm, flops = 0.0, float(sum(t.numel() for t in outs))
            self._record(packet.__name__, flops, mm, n_bytes)
        return out

    def kernel(self, name: str, operands: List[torch.Tensor],
               results: List[torch.Tensor]) -> None:
        """A hand-written kernel's launch: one op, its bytes, 0 FLOPs."""
        with self._lock:
            for t in (*operands, *results):
                self._track(t)
            self._record(name, 0.0, 0.0,
                         float(_nbytes(operands) + _nbytes(results)))

    def __enter__(self):
        _trace.counters.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _trace.counters.remove(self)
        return super().__exit__(*exc)

    # -- results -----------------------------------------------------------
    def totals(self) -> Dict:
        """The reference's ``analyze_text`` dictionary (``flops``,
        ``bytes``, ``collectives``, ``collective_counts``), with
        ``matmul_flops`` beside it."""
        return {"flops": self.flops, "bytes": self.bytes,
                "matmul_flops": self.matmul_flops,
                "collectives": {}, "collective_counts": {}}

    def totals_outside(self, prefix: Optional[str] = None) -> Dict:
        """``flops``, ``matmul_flops``, ``bytes`` and ``n_ops`` of the
        records whose function does not start with ``prefix`` (of all of
        them without one)."""
        out = {"flops": 0.0, "matmul_flops": 0.0, "bytes": 0.0, "n_ops": 0}
        for (op, where), (count, flops, n_bytes) in self.records.items():
            if prefix is not None and where.startswith(prefix):
                continue
            out["n_ops"] += count
            out["flops"] += flops
            out["bytes"] += n_bytes
            out["matmul_flops"] += flops if op in _MATMUL_NAMES else 0.0
        return out

    def top(self, n: int, by: str = "bytes") -> List[Tuple[float, str, str]]:
        """The ``n`` largest (value, op, function) records by ``bytes`` or
        ``flops``."""
        i = {"flops": 1, "bytes": 2}[by]
        rows = [(v[i], op, where) for (op, where), v in self.records.items()
                if v[i]]
        return sorted(rows, key=lambda r: -r[0])[:n]


def link_bytes(collectives: Dict[str, float]) -> float:
    """Effective per-device bytes crossing links:
    all-reduce 2×(g-1)/g (ring), all-gather/reduce-scatter/all-to-all
    (g-1)/g × size, collective-permute 1× — g = replica-group size."""
    total = 0.0
    for kind in COLLECTIVES:
        size = collectives.get(kind, 0.0)
        if not size:
            continue
        g = max(collectives.get(kind + ":group", 0.0), 2.0)
        eff = (g - 1.0) / g
        if kind == "all-reduce":
            total += 2.0 * eff * size
        elif kind == "collective-permute":
            total += size
        else:
            total += eff * size
    return total
