"""n-ary word-aligned logical reduction with clean-block skipping: the CUDA
kernel's wrapper, its plain PyTorch version and its launch plan.

``fold`` computes ``fold_op(pos rows) & ~OR(neg rows)`` over 1-D ``int32``
word rows (the bit-casts of NumPy ``uint32`` words), op in and/or/xor:
with no neg rows it is ``ops.logical_reduce``, with op ``and`` the
executor's AND-NOT node.  Each row comes with its own flag row, one
DIRTY / CLEAN0 / CLEAN1 flag per 1024 words (``ops.np_row_flags``,
``ops.container_row_flags``), or ``None`` when every block is to be read.
Flags may be conservative (DIRTY for a block that is constant) but never
claim a block clean that is not.

One launch of ``csrc/logical_reduce.cu`` takes up to ``MAX_ROWS`` rows where
they lie and writes the result row and its exact flag row.  More rows chain
launches: each later launch folds the running result, as a pos row, with the
next ``MAX_ROWS`` rows, so a call makes ceil(rows / ``MAX_ROWS``) launches.

Each launch dispatches on the rows' device: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel (or raises).  ``launches``
counts kernel launches, and nothing else.
"""
from __future__ import annotations

import array
import ctypes
import functools
import threading
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _trace
from .word_logical import CLEAN0, CLEAN1, DIRTY

OPS = ("and", "or", "xor")

MAX_ROWS = 128     # operand rows one launch takes (csrc: kMaxRows)
FLAG_COLS = 1024   # words per flag

# CUDA kernel launches since import (or since a caller reset it); shards
# of one statement may launch from the threads of a pool, so the count is
# taken under a lock
launches = 0
_launches_lock = threading.Lock()

Flags = Optional[torch.Tensor]


def n_flag_cols(n_words: int) -> int:
    """Flags a row of ``n_words`` words has: one per 1024, the last ragged."""
    return -(-n_words // FLAG_COLS)


def row_flags(words: torch.Tensor) -> torch.Tensor:
    """Exact flags of an (R, C) int32 word tensor, (R, ceil(C/1024)), on
    its device; a ragged last block is described by the words present."""
    pad = n_flag_cols(words.shape[1]) * FLAG_COLS - words.shape[1]
    shape = (words.shape[0], -1, FLAG_COLS)
    all0 = (F.pad(words, (0, pad), value=0).reshape(shape) == 0).all(-1)
    all1 = (F.pad(words, (0, pad), value=-1).reshape(shape) == -1).all(-1)
    return torch.where(all0, CLEAN0,
                       torch.where(all1, CLEAN1, DIRTY)).to(torch.int32)


def _value(row: torch.Tensor, flags: Flags) -> torch.Tensor:
    """The row with each clean block replaced by its constant word."""
    if flags is None:
        return row
    C = row.numel()
    fw = flags[:n_flag_cols(C)].repeat_interleave(FLAG_COLS)[:C]
    const = torch.where(fw == CLEAN1, -1, 0).to(torch.int32)
    return torch.where(fw == DIRTY, row, const)


def fold_plain(rows: Sequence[torch.Tensor], flags: Sequence[Flags],
               n_pos: int, op: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of one launch: clean blocks substituted by their
    constant, then ``fold_op(rows[:n_pos]) & ~OR(rows[n_pos:])``; returns
    the result row and its exact flag row."""
    vals = [_value(r, f) for r, f in zip(rows, flags)]
    out = functools.reduce(
        {"and": torch.bitwise_and, "or": torch.bitwise_or,
         "xor": torch.bitwise_xor}[op], vals[:n_pos])
    if n_pos < len(vals):
        out = out & ~functools.reduce(torch.bitwise_or, vals[n_pos:])
    return out, row_flags(out[None])[0]


def _check(rows: List[torch.Tensor], flags: List[Flags]) -> None:
    """Every row a 1-D int32 tensor of one length on row 0's device, every
    flag row None or 1-D int32 on that device with a flag per 1024 words.
    Set comprehensions, one attribute a pass: this runs on every call, over
    up to hundreds of rows."""
    r0 = rows[0]
    if not isinstance(r0, torch.Tensor):
        raise TypeError(f"rows must be torch.Tensors, got "
                        f"{type(r0).__name__}")
    dev = r0.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"logical_reduce runs on cpu or cuda, not {dev}")
    given = [f for f in flags if f is not None]
    try:
        dtypes = {t.dtype for t in rows} | {f.dtype for f in given}
        row_shapes = {r.shape for r in rows}
        flag_shapes = {f.shape for f in given}
        devices = {t.get_device() for t in rows} | \
            {f.get_device() for f in given}
    except AttributeError:
        raise TypeError("rows and flag rows must be torch.Tensors") from None
    if dtypes != {torch.int32} or \
            any(len(s) != 1 for s in row_shapes | flag_shapes):
        raise TypeError(f"rows and flag rows must be 1-D int32 tensors, got "
                        f"{sorted(map(str, dtypes))} of shapes "
                        f"{sorted(map(tuple, row_shapes | flag_shapes))}")
    if len(row_shapes) != 1:
        raise ValueError(f"rows of {sorted(s[0] for s in row_shapes)} "
                         f"words: all must have one length")
    nfc = n_flag_cols(r0.shape[0])
    short = [s[0] for s in flag_shapes if s[0] < nfc]
    if short:
        raise ValueError(f"a flag row has {short[0]} entries; "
                         f"{r0.shape[0]} words need {nfc}")
    if devices != {r0.get_device()}:
        raise ValueError(f"rows and flag rows must all be on {dev}")


def fold(pos: Sequence[torch.Tensor], pos_flags: Sequence[Flags],
         neg: Sequence[torch.Tensor] = (), neg_flags: Sequence[Flags] = (),
         op: str = "and") -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``fold_op(pos) & ~OR(neg)`` of 1-D int32 word rows of one length;
    returns the result row and its flag row.  One pos row and no neg rows
    is returned as it is, with its flags, and launches nothing."""
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    if len(pos) != len(pos_flags) or len(neg) != len(neg_flags):
        raise ValueError(f"{len(pos)} pos and {len(neg)} neg rows need as "
                         f"many flag rows, got {len(pos_flags)} and "
                         f"{len(neg_flags)}")
    if not pos:
        raise ValueError("fold needs at least one pos row")
    rows, flags = [*pos, *neg], [*pos_flags, *neg_flags]
    _check(rows, flags)
    if len(rows) == 1:
        return rows[0], flags[0]
    C, dev = rows[0].numel(), rows[0].device
    if C == 0:
        return torch.empty(0, dtype=torch.int32, device=dev), \
            torch.empty(0, dtype=torch.int32, device=dev)
    one = fold_plain if dev.type == "cpu" else _launch
    acc: List[torch.Tensor] = []
    acc_flags: List[Flags] = []
    for start in range(0, len(rows), MAX_ROWS):
        stop = min(start + MAX_ROWS, len(rows))
        n_pos = len(acc) + max(0, min(stop, len(pos)) - start)
        out, out_flags = one(acc + rows[start:stop],
                             acc_flags + flags[start:stop], n_pos, op)
        acc, acc_flags = [out], [out_flags]
    return acc[0], acc_flags[0]


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    from ._build import library
    fn = library("logical_reduce").logical_reduce_launch
    # every pointer, the two host pointer arrays and the stream as
    # c_void_p: a bare Python int would be passed as a 32-bit int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(rows: Sequence[torch.Tensor], flags: Sequence[Flags],
            n_pos: int, op: str) -> Tuple[torch.Tensor, torch.Tensor]:
    global launches
    if len(rows) > MAX_ROWS + 1:
        raise ValueError(f"one launch takes at most {MAX_ROWS + 1} rows, "
                         f"got {len(rows)}")
    given = [f for f in flags if f is not None]
    if {r.is_contiguous() for r in rows} | \
            {f.is_contiguous() for f in given} != {True}:
        raise ValueError("rows and flag rows must be contiguous")
    C = rows[0].shape[0]
    if n_flag_cols(C) * 4 >= 2 ** 31:
        raise ValueError(f"{C} words is too many blocks for one grid")
    ptrs = [r.data_ptr() for r in rows]
    vec = C % 4 == 0 and not any(p % 16 for p in ptrs)
    fn = _kernel_fn()
    out = torch.empty(C, dtype=torch.int32, device=rows[0].device)
    out_flags = torch.empty(n_flag_cols(C), dtype=torch.int32,
                            device=rows[0].device)
    # the two host pointer tables as uint64 arrays (a tenth of the cost of
    # ctypes arrays); 0 is a null flag pointer
    row_ptrs = array.array("Q", ptrs)
    flag_ptrs = array.array("Q", [0 if f is None else f.data_ptr()
                                  for f in flags])
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        # rows and flags stay referenced by the caller's lists until the
        # launch is enqueued
        err = fn(row_ptrs.buffer_info()[0], flag_ptrs.buffer_info()[0],
                 len(rows), n_pos, out.data_ptr(), out_flags.data_ptr(), C,
                 OPS.index(op), int(vec), stream)
    if err:
        raise RuntimeError(f"logical_reduce launch failed: CUDA error {err}")
    with _launches_lock:
        launches += 1
    _trace.launched("logical_reduce", [*rows, *given], (out, out_flags))
    return out, out_flags
