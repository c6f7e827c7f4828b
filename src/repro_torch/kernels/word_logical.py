"""Word-aligned logical ops with clean-tile skipping: the CUDA kernel's
wrapper, its plain PyTorch version and the tile-flag sideband.

The device form of EWAH's Lemma 2: bitmaps live on the device as dense
32-bit word arrays cut into (8, 1024) tiles, and a per-tile *flag* says
whether a tile is clean (all-0 / all-1).  Clean×any tiles resolve from flag
algebra; only dirty operand tiles that the result depends on are read.

Words are ``int32`` tensors, the bit-casts of the NumPy ``uint32`` words
(``np_words.view(np.int32)``): the all-ones word is ``-1``.  The CUDA code
(``csrc/word_logical.cu``, which replaces the Pallas TPU kernel of the
reference package) reads the same buffers as ``uint32_t``.

``word_logical`` dispatches on the tensors' device: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel (or raises).  ``launches``
counts kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _trace

# flag values for a tile
DIRTY = 0
CLEAN0 = 1
CLEAN1 = 2

OPS = ("and", "or", "xor", "andnot")

BLOCK_ROWS = 8
BLOCK_COLS = 1024

# CUDA kernel launches since import (or since a caller reset it)
launches = 0


def _apply(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if op == "and":
        return a & b
    if op == "or":
        return a | b
    if op == "xor":
        return a ^ b
    return a & ~b  # andnot


def _expand(flags: torch.Tensor) -> torch.Tensor:
    """(gr, gc) tile flags -> (R, C) per-word flags."""
    return flags.repeat_interleave(BLOCK_ROWS, 0) \
        .repeat_interleave(BLOCK_COLS, 1)


def word_logical_plain(a: torch.Tensor, b: torch.Tensor,
                       flags_a: torch.Tensor, flags_b: torch.Tensor,
                       op: str = "and") -> torch.Tensor:
    """The plain version: clean tiles replaced by their constant word (0 or
    -1), then the word op over everything."""
    fa, fb = _expand(flags_a), _expand(flags_b)
    zero = torch.zeros((), dtype=torch.int32, device=a.device)
    ones = torch.full((), -1, dtype=torch.int32, device=a.device)
    av = torch.where(fa == DIRTY, a, torch.where(fa == CLEAN1, ones, zero))
    bv = torch.where(fb == DIRTY, b, torch.where(fb == CLEAN1, ones, zero))
    return _apply(op, av, bv)


def _check(a, b, flags_a, flags_b, op):
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    for name, t in (("a", a), ("b", b), ("flags_a", flags_a),
                    ("flags_b", flags_b)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a is on {a.device}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
    R, C = a.shape
    if b.shape != a.shape:
        raise ValueError(f"shape mismatch: a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}")
    if R % BLOCK_ROWS or C % BLOCK_COLS:
        raise ValueError(f"shape {(R, C)} is not a multiple of the "
                         f"({BLOCK_ROWS}, {BLOCK_COLS}) tile")
    grid = (R // BLOCK_ROWS, C // BLOCK_COLS)
    if tuple(flags_a.shape) != grid or tuple(flags_b.shape) != grid:
        raise ValueError(f"flags must be {grid}, got {tuple(flags_a.shape)} "
                         f"and {tuple(flags_b.shape)}")


def word_logical(a: torch.Tensor, b: torch.Tensor, flags_a: torch.Tensor,
                 flags_b: torch.Tensor, op: str = "and") -> torch.Tensor:
    """op(a, b) over (R, C) int32 word tensors with (R/8, C/1024) tile
    flags; R % 8 == 0 and C % 1024 == 0."""
    _check(a, b, flags_a, flags_b, op)
    if a.device.type == "cpu":
        return word_logical_plain(a, b, flags_a, flags_b, op)
    if a.device.type != "cuda":
        raise ValueError(f"word_logical runs on cpu or cuda, not {a.device}")
    return _launch(a, b, flags_a, flags_b, op)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    from ._build import library
    fn = library("word_logical").word_logical_launch
    # every pointer and the stream as c_void_p: a bare Python int would be
    # passed as a 32-bit int and cut the address
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int64,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(a, b, flags_a, flags_b, op):
    global launches
    for name, t in (("a", a), ("b", b), ("flags_a", flags_a),
                    ("flags_b", flags_b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in ("a", "b") and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    R, C = a.shape
    if (R // BLOCK_ROWS) * (C // BLOCK_COLS) >= 2 ** 31:
        raise ValueError(f"shape {(R, C)} has too many tiles for one grid")
    fn = _kernel_fn()
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), flags_a.data_ptr(),
                 flags_b.data_ptr(), out.data_ptr(), R, C, OPS.index(op),
                 stream)
    if err:
        raise RuntimeError(f"word_logical launch failed: CUDA error {err}")
    launches += 1
    _trace.launched("word_logical", (a, b, flags_a, flags_b), (out,))
    return out


def tile_flags(words: torch.Tensor) -> torch.Tensor:
    """The clean-tile sideband (DIRTY/CLEAN0/CLEAN1) of an (R, C) int32
    word tensor, computed on its device."""
    R, C = words.shape
    gr, gc = R // BLOCK_ROWS, C // BLOCK_COLS
    t = words.reshape(gr, BLOCK_ROWS, gc, BLOCK_COLS)
    all0 = (t == 0).all(dim=3).all(dim=1)
    all1 = (t == -1).all(dim=3).all(dim=1)
    return torch.where(all0, CLEAN0,
                       torch.where(all1, CLEAN1, DIRTY)).to(torch.int32)
