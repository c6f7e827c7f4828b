"""Set-bit counts of word matrices: the CUDA kernels' wrappers and their
plain PyTorch versions.

``popcount_total`` counts every set bit of an (R, C) word matrix and
``popcount_rows`` the set bits of each row: the planner's selectivity
signal (``ColumnIndex.bitmap_count``) and the paper's 1 - C/N profiles.
The CUDA code (``csrc/popcount.cu``, which replaces the two Pallas TPU
kernels of the reference package) reads the ``int32`` word bit-casts as
``uint32``.  Counts are ``int32`` and wrap mod 2^32, as the reference's
int32 sums do: an all-ones matrix of 2^26 words counts -2^31.

Both dispatch on the tensor's device: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel (or raises).  ``launches``
counts each kernel's launches, by name, and nothing else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _trace

# CUDA kernel launches since import (or since a caller reset them)
launches = {"popcount_total": 0, "popcount_rows": 0}

# words a plain-version step widens to int64 at once
_PLAIN_CHUNK_WORDS = 1 << 24


def _bit_counts(w: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word, as int64: SWAR over the word's 32
    unsigned bits (masked into int64, since int32 ``>>`` is arithmetic)."""
    v = w.to(torch.int64)
    v &= 0xFFFFFFFF
    t = v >> 1
    t &= 0x55555555
    v -= t
    t = v >> 2
    t &= 0x33333333
    v &= 0x33333333
    v += t
    del t
    v += v >> 4
    v &= 0x0F0F0F0F
    v += v >> 8
    v += v >> 16
    v &= 0x3F
    return v


def _row_counts(a: torch.Tensor) -> torch.Tensor:
    """(R, C) int32 words -> (R,) int64 set bits per row, a few rows at a
    time so the int64 temporaries stay within a few times one chunk."""
    R, C = a.shape
    out = torch.zeros(R, dtype=torch.int64, device=a.device)
    step = max(1, _PLAIN_CHUNK_WORDS // max(C, 1))
    for s in range(0, R, step):
        out[s:s + step] = _bit_counts(a[s:s + step]).sum(dim=1)
    return out


def popcount_rows_plain(a: torch.Tensor) -> torch.Tensor:
    """The plain version: (R, C) int32 words -> (R,) int32 set bits per
    row, wrapping mod 2^32."""
    return _row_counts(a).to(torch.int32)


def popcount_total_plain(a: torch.Tensor) -> torch.Tensor:
    """The plain version: (R, C) int32 words -> 0-d int32 total set bits,
    wrapping mod 2^32."""
    return _row_counts(a).sum().to(torch.int32)


def _check(a) -> None:
    if not isinstance(a, torch.Tensor):
        raise TypeError(f"a must be a torch.Tensor of int32 words, got "
                        f"{type(a).__name__}")
    if a.dtype != torch.int32 or a.dim() != 2:
        raise TypeError(f"a must be a 2-D int32 tensor, got {a.dtype} of "
                        f"shape {tuple(a.shape)}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"popcount runs on cpu or cuda, not {a.device}")


def popcount_total(a: torch.Tensor) -> torch.Tensor:
    """Total set bits of an (R, C) int32 word tensor, as a 0-d int32
    tensor on its device (mod 2^32)."""
    _check(a)
    if a.device.type == "cpu":
        return popcount_total_plain(a)
    a = a.contiguous()
    if a.numel() == 0:
        return torch.zeros((), dtype=torch.int32, device=a.device)
    # the launch zeroes the counter before the kernel adds into it
    out = torch.empty((), dtype=torch.int32, device=a.device)
    fn = _kernel_fns()[0]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), out.data_ptr(), a.numel(), stream)
    if err:
        raise RuntimeError(f"popcount_total launch failed: CUDA error {err}")
    launches["popcount_total"] += 1
    _trace.launched("popcount_total", (a,), (out,))
    return out


def popcount_rows(a: torch.Tensor) -> torch.Tensor:
    """Set bits of each row of an (R, C) int32 word tensor, as (R,) int32
    on its device (mod 2^32)."""
    _check(a)
    if a.device.type == "cpu":
        return popcount_rows_plain(a)
    a = a.contiguous()
    R, C = a.shape
    if R == 0 or C == 0:
        return torch.zeros(R, dtype=torch.int32, device=a.device)
    if R >= 2 ** 31:
        raise ValueError(f"{R} rows do not fit one grid")
    out = torch.empty(R, dtype=torch.int32, device=a.device)
    fn = _kernel_fns()[1]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), out.data_ptr(), R, C, stream)
    if err:
        raise RuntimeError(f"popcount_rows launch failed: CUDA error {err}")
    launches["popcount_rows"] += 1
    _trace.launched("popcount_rows", (a,), (out,))
    return out


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    from ._build import library
    lib = library("popcount")
    # pointers and the stream as c_void_p: a bare Python int would be
    # passed as a 32-bit int and cut the address
    total = lib.popcount_total_launch
    total.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                      ctypes.c_void_p]
    total.restype = ctypes.c_int
    rows = lib.popcount_rows_launch
    rows.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                     ctypes.c_int64, ctypes.c_void_p]
    rows.restype = ctypes.c_int
    return total, rows
