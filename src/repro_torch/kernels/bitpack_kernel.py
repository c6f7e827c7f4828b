"""Bit packing of (rows x bitmaps) bools into 32-bit words: the CUDA
kernel's wrapper and its plain PyTorch version.

The inner loop of the index build (the paper's Algorithm 3): 32
consecutive rows of a bitmap column become one word, bit i of word w
holding row 32 w + i (the codec's little-endian convention).  (N, L) bools
become (ceil(N / 32), L) ``int32`` words (bit-casts of ``uint32``); rows
past N are zero bits.  The CUDA code (``csrc/bitpack.cu``, which replaces
the Pallas TPU kernel of the reference package) takes any N and L, with
no padding to the reference's (1024, 128) tile.

``bitpack`` dispatches on the tensor's device: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel (or raises).  ``launches``
counts kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _trace

WORD_BITS = 32

# CUDA kernel launches since import (or since a caller reset it)
launches = 0


def bitpack_plain(bits: torch.Tensor) -> torch.Tensor:
    """The plain version: (N, L) bool -> (ceil(N / 32), L) int32 words, one
    bit plane at a time (int32 ``<<`` is bit-exact, ``1 << 31`` included)."""
    N, L = bits.shape
    n_words = -(-N // WORD_BITS)
    pad = n_words * WORD_BITS - N
    if pad:
        bits = torch.cat([bits, bits.new_zeros(pad, L)])
    out = torch.zeros((n_words, L), dtype=torch.int32, device=bits.device)
    for i in range(WORD_BITS):
        out |= bits[i::WORD_BITS].to(torch.int32) << i
    return out


def bitpack(bits: torch.Tensor) -> torch.Tensor:
    """Pack an (N, L) tensor of bits into (ceil(N / 32), L) int32 words on
    its device.  A dtype other than bool is read as ``bits != 0``."""
    if not isinstance(bits, torch.Tensor):
        raise TypeError(f"bits must be a torch.Tensor, got "
                        f"{type(bits).__name__}")
    if bits.dim() != 2:
        raise ValueError(f"bits must be 2-D, got shape {tuple(bits.shape)}")
    if bits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bitpack runs on cpu or cuda, not {bits.device}")
    if bits.dtype != torch.bool:
        bits = bits != 0
    bits = bits.contiguous()
    if bits.device.type == "cpu":
        return bitpack_plain(bits)
    return _launch(bits)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    from ._build import library
    fn = library("bitpack").bitpack_launch
    # pointers and the stream as c_void_p: a bare Python int would be
    # passed as a 32-bit int and cut the address
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(bits: torch.Tensor) -> torch.Tensor:
    global launches
    N, L = bits.shape
    n_words = -(-N // WORD_BITS)
    out = torch.empty((n_words, L), dtype=torch.int32, device=bits.device)
    if out.numel() == 0:
        return out
    fn = _kernel_fn()
    with torch.cuda.device(bits.device):
        stream = torch.cuda.current_stream(bits.device).cuda_stream
        err = fn(bits.data_ptr(), out.data_ptr(), N, L, stream)
    if err:
        raise RuntimeError(f"bitpack launch failed: CUDA error {err}")
    launches += 1
    _trace.launched("bitpack", (bits,), (out,))
    return out
