"""Blockwise gradient statistics for the EWAH sparse gradient exchange: the
CUDA kernel's wrapper, its plain PyTorch version and the keep mask.

The distributed substrate sparsifies gradients block-wise: it keeps the
highest-energy blocks of 256 values and ships the keep bitmap (EWAH) plus
the packed payload.  ``block_sqnorms`` computes the per-block squared L2
norms in one pass; ``topk_block_mask`` derives the keep threshold and mask
from them.  The CUDA code (``csrc/grad_compress.cu``) replaces the Pallas
TPU kernel of the reference package; unlike that kernel's 512-block tiles
it takes any block count.

``block_sqnorms`` dispatches on the tensor's device: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel (or raises), and a meta
tensor (the dry-run's) gets the kernel's result shape and launches nothing.
``launches`` counts kernel launches, and nothing else.  Each launch, and
the launch a meta tensor stands for, is reported to the active cost
counters (``kernels/_trace.py``).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _trace

VALUES_PER_BLOCK = 256   # gradient values per compression block

# CUDA kernel launches since import (or since a caller reset it)
launches = 0


def block_sqnorms_plain(grad_flat: torch.Tensor,
                        values_per_block: int = VALUES_PER_BLOCK
                        ) -> torch.Tensor:
    """The plain version: (n_blocks * values_per_block,) -> (n_blocks,)
    float32 sums of squares."""
    return (grad_flat.view(-1, values_per_block).float() ** 2).sum(1)


def block_sqnorms(grad_flat: torch.Tensor,
                  values_per_block: int = VALUES_PER_BLOCK) -> torch.Tensor:
    """Squared L2 norm of every ``values_per_block``-value block of a flat
    gradient, in float32.  The input is cast to float32 and zero-padded to
    a block multiple, so a ragged last block counts its values alone.

    On a CUDA tensor only ``values_per_block == 256`` is taken: the kernel
    has no other block width, and any other raises.
    """
    if not isinstance(grad_flat, torch.Tensor):
        raise TypeError(f"grad_flat must be a torch.Tensor, got "
                        f"{type(grad_flat).__name__}")
    if grad_flat.dim() != 1:
        raise ValueError(f"grad_flat must be 1-D, got shape "
                         f"{tuple(grad_flat.shape)}")
    if not grad_flat.is_contiguous():
        raise ValueError("grad_flat must be contiguous")
    if values_per_block < 1:
        raise ValueError(f"values_per_block must be >= 1, got "
                         f"{values_per_block}")
    g = grad_flat.float()
    pad = -g.numel() % values_per_block
    if pad:
        g = F.pad(g, (0, pad))
    if g.device.type == "cpu":
        return block_sqnorms_plain(g, values_per_block)
    if g.device.type not in ("cuda", "meta"):
        raise ValueError(f"block_sqnorms runs on cpu, cuda or meta, not "
                         f"{g.device}")
    if values_per_block != VALUES_PER_BLOCK:
        raise ValueError(f"the CUDA kernel takes blocks of "
                         f"{VALUES_PER_BLOCK} values, not {values_per_block}")
    return _launch(g)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    from ._build import library
    fn = library("grad_compress").block_sqnorms_launch
    # pointers and the stream as c_void_p: a bare Python int would be
    # passed as a 32-bit int and cut the address
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(g: torch.Tensor) -> torch.Tensor:
    global launches
    if g.device.type == "cuda" and g.data_ptr() % 16:
        raise ValueError("grad_flat must be 16-byte aligned")
    n_blocks = g.numel() // VALUES_PER_BLOCK
    out = torch.empty(n_blocks, dtype=torch.float32, device=g.device)
    if n_blocks == 0:
        return out
    if g.device.type == "meta":
        _trace.launched("block_sqnorms", (g,), (out,))
        return out
    fn = _kernel_fn()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = fn(g.data_ptr(), out.data_ptr(), n_blocks, stream)
    if err:
        raise RuntimeError(f"block_sqnorms launch failed: CUDA error {err}")
    launches += 1
    _trace.launched("block_sqnorms", (g,), (out,))
    return out


def topk_block_mask(grad_flat: torch.Tensor, keep_ratio: float,
                    values_per_block: int = VALUES_PER_BLOCK
                    ) -> torch.Tensor:
    """Boolean keep mask over compression blocks (True = block survives):
    the blocks whose squared norm is at least the k-th largest, with
    ``k = max(int(n_blocks * keep_ratio), 1)``.  Ties at the threshold are
    all kept, as with the reference's ``lax.top_k``."""
    norms = block_sqnorms(grad_flat, values_per_block)
    k = max(int(norms.numel() * keep_ratio), 1)
    thresh = torch.topk(norms, k).values[-1]
    return norms >= thresh
