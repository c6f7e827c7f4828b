"""Public wrappers around the word-logical kernels: the pairwise
``word_logical`` with its padding glue, and the n-ary ``logical_reduce``
and ``diff_reduce`` (folded by ``logical_reduce.fold``); the
gradient-compression kernel's ``block_sqnorms`` and ``topk_block_mask``
(defined in ``grad_compress``); and ``popcount_total``,
``popcount_rows`` (defined in ``popcount``) and ``bitpack`` (defined in
``bitpack_kernel``), with the reference's signatures.

Words are ``int32`` tensors (bit-casts of the NumPy ``uint32`` words) on an
explicit device: a CPU tensor takes each kernel's plain version, a CUDA
tensor launches the kernel.  ``resolve_device`` is where the package's
entry points turn a device name into a ``torch.device``; it raises when
CUDA is asked for and absent — there is no fallback to the CPU.

Shape bucketing: the executor pads each bitmap's words up to a
power-of-two multiple of the 1024-word block (``bucket_cols``) and caches
them with their per-row clean flags (``np_row_flags``, on the device), so
the sideband is not recomputed per query.  The pairwise ``word_logical``
pads its operands to that bucket and to (8, 1024) tiles; the n-ary
reductions take rows of any length where they lie.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from . import logical_reduce as _lr
from . import word_logical as _wl
from .bitpack_kernel import bitpack  # noqa: F401
from .grad_compress import block_sqnorms, topk_block_mask  # noqa: F401
from .popcount import popcount_rows, popcount_total  # noqa: F401

_ALL_ONES = np.uint32(0xFFFFFFFF)


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``torch.device(device)``; raises if it names CUDA and CUDA is not
    available.  The CPU is used only when the caller asks for it.
    ``"meta"`` builds shapes and dtypes with nothing allocated (the
    dry-run's device)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            f"pass device='cpu' (--device cpu on a command line) to run "
            f"the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"device must be cuda, cpu or meta, got {dev}")
    return dev


def to_device_words(words: np.ndarray, device) -> torch.Tensor:
    """NumPy ``uint32`` words -> ``int32`` bit-cast tensor on ``device``."""
    w = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(w).to(device)


def to_numpy_words(t: torch.Tensor) -> np.ndarray:
    """``int32`` word tensor -> NumPy ``uint32`` words on the host."""
    return t.cpu().numpy().view(np.uint32)


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (>= 1)."""
    return 1 << max(0, int(x) - 1).bit_length() if x > 1 else 1


def bucket_cols(n_words: int, block_cols: int = 1024) -> int:
    """Bucketed (padded) word count: block_cols x next power of two.

    All operands whose word counts fall in the same bucket share one
    kernel shape; padding words are zero and sliced away by the caller.
    """
    return block_cols * next_pow2(-(-max(int(n_words), 1) // block_cols))


def np_row_flags(words: np.ndarray, block_cols: int = 1024) -> np.ndarray:
    """Host-side per-row clean flags for a bucketed word row (or matrix).

    ``words``' last axis must be a multiple of ``block_cols``; returns
    DIRTY/CLEAN0/CLEAN1 per ``block_cols`` span.  Cacheable alongside the
    padded words (one cheap pass at load time instead of one per query).
    """
    t = words.reshape(words.shape[:-1] + (-1, block_cols))
    all0 = (t == 0).all(axis=-1)
    all1 = (t == _ALL_ONES).all(axis=-1)
    return np.where(all0, _wl.CLEAN0,
                    np.where(all1, _wl.CLEAN1, _wl.DIRTY)).astype(np.int32)


def container_row_flags(cont, padded_words: int,
                        block_cols: int = 1024) -> np.ndarray:
    """Per-block clean flags straight off a container chunk directory.

    Equivalent to ``np_row_flags`` on the padded dense words, but EMPTY /
    FULL chunks resolve from the directory alone and ARRAY chunks from a
    position shift — only DENSE / RUN chunk payloads are scanned.  The
    flags are exact (bit-identical to ``np_row_flags``), not merely
    conservative, so kernel short-circuiting is equally effective.
    """
    from repro_torch.core import containers as C  # lazy: avoid import cycle
    if C.CHUNK_WORDS % block_cols:
        return np_row_flags(_np_pad_words(C.containers_to_dense(cont),
                                          padded_words), block_cols)
    bpc = C.CHUNK_WORDS // block_cols          # blocks per chunk
    bits_per_block = block_cols * 32
    n_blocks = padded_words // block_cols
    flags = np.full(n_blocks, _wl.CLEAN0, dtype=np.int32)
    for i in range(cont.n_chunks):
        t, _, payload = cont.chunk(i)
        if t == C.T_EMPTY:
            continue
        b0, nw = i * bpc, cont.chunk_nw(i)
        nb = -(-nw // block_cols)              # blocks this chunk spans
        if t == C.T_FULL:
            fb = nw // block_cols              # fully covered blocks
            flags[b0:b0 + fb] = _wl.CLEAN1
            if nw % block_cols:                # ragged tail: ones then pad
                flags[b0 + fb] = _wl.DIRTY
            continue
        if t == C.T_ARRAY:
            # a block holding any position is DIRTY (all-ones needs 32768
            # positions, above any array cutoff); empty blocks stay CLEAN0
            occupied = np.unique(np.asarray(payload).astype(np.int64)
                                 // bits_per_block)
            flags[b0 + occupied] = _wl.DIRTY
            continue
        w = C._to_chunk_words(t, payload, nw)
        if nw % block_cols:
            w = np.pad(w, (0, nb * block_cols - nw))
        tw = w.reshape(nb, block_cols)
        all0 = (tw == 0).all(axis=1)
        all1 = (tw == _ALL_ONES).all(axis=1)
        flags[b0:b0 + nb] = np.where(
            all0, _wl.CLEAN0,
            np.where(all1, _wl.CLEAN1, _wl.DIRTY)).astype(np.int32)
    return flags


def _np_pad_words(w: np.ndarray, padded_words: int) -> np.ndarray:
    return np.pad(w, (0, padded_words - len(w))) \
        if len(w) < padded_words else w


def _combine_row_flags(rf: torch.Tensor) -> torch.Tensor:
    """Conservatively merge (R, gc) per-row flags into (R/8, gc) tile flags
    (a tile mixing clean values — or any dirty row — is DIRTY)."""
    R, gc = rf.shape
    br = _wl.BLOCK_ROWS
    t = rf.reshape(R // br, br, gc)
    all0 = (t == _wl.CLEAN0).all(dim=1)
    all1 = (t == _wl.CLEAN1).all(dim=1)
    return torch.where(all0, _wl.CLEAN0,
                       torch.where(all1, _wl.CLEAN1, _wl.DIRTY)) \
        .to(torch.int32)


def _pad2(a: torch.Tensor, br: int, bc: int,
          fill: int = 0) -> Tuple[torch.Tensor, Tuple[int, int]]:
    R, C = a.shape
    Rp = -(-R // br) * br
    Cp = -(-C // bc) * bc
    if (Rp, Cp) != (R, C):
        out = torch.full((Rp, Cp), fill, dtype=a.dtype, device=a.device)
        out[:R, :C] = a
        a = out
    return a.contiguous(), (R, C)


def _pad_rows(rf: Optional[torch.Tensor],
              rows: int) -> Optional[torch.Tensor]:
    br = _wl.BLOCK_ROWS
    pad = -(-rows // br) * br - rows
    if rf is None or pad == 0:
        return rf
    # zero-filled pad rows are clean-zero
    fill = torch.full((pad, rf.shape[1]), _wl.CLEAN0, dtype=rf.dtype,
                      device=rf.device)
    return torch.cat([rf, fill])


def _check_words(name: str, t) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor of int32 words, "
                        f"got {type(t).__name__}")
    if t.dtype != torch.int32 or t.dim() != 2:
        raise TypeError(f"{name} must be a 2-D int32 tensor, got "
                        f"{t.dtype} of shape {tuple(t.shape)}")


def word_logical(a: torch.Tensor, b: torch.Tensor, op: str = "and",
                 row_flags_a: Optional[torch.Tensor] = None,
                 row_flags_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Word-aligned logical op over (L, n_words) int32 word tensors.

    Runs the clean-tile-skipping kernel — the device-side equivalent of
    EWAH's Lemma 2 — on the tensors' device.  The word dimension pads to a
    power-of-two bucket of (8, 1024) tiles.  ``row_flags_*`` are optional
    precomputed ``np_row_flags`` sidebands for the (bucketed) inputs, as
    int32 tensors on the same device; absent, flags are computed on the
    device.
    """
    _check_words("a", a)
    _check_words("b", b)
    bc_pad = bucket_cols(a.shape[1], _wl.BLOCK_COLS)
    ap, orig = _pad2(a, _wl.BLOCK_ROWS, bc_pad)
    bp_, _ = _pad2(b, _wl.BLOCK_ROWS, bc_pad)
    if row_flags_a is None:
        fa = _wl.tile_flags(ap)
    else:
        fa = _combine_row_flags(_pad_rows(row_flags_a, orig[0]))
    if row_flags_b is None:
        fb = _wl.tile_flags(bp_)
    else:
        fb = _combine_row_flags(_pad_rows(row_flags_b, orig[0]))
    out = _wl.word_logical(ap, bp_, fa.contiguous(), fb.contiguous(), op=op)
    return out[: orig[0], : orig[1]]


def logical_reduce(mat, op: str = "and", row_flags=None) -> torch.Tensor:
    """Reduce the rows of an (L, n_words) int32 word tensor to one word row.

    One launch of the fused ``logical_reduce`` kernel per ``MAX_ROWS`` rows
    (``kernels/logical_reduce.py``) reads every row where it lies, skips
    the blocks that the flags make clean, and writes the one result row:
    no row stack, no padding copy, no intermediate rows.  ``mat`` may also
    be a sequence of 1-D word rows of one length, as the executor's cache
    holds them.  ``row_flags`` is the optional (L, cols/1024) precomputed
    clean sideband of the (bucketed) input rows (an int32 tensor on the same
    device, or a sequence of 1-D flag rows); without it every block is
    read, which is what computing the flags would cost.
    """
    if op not in _lr.OPS:  # associative ops only
        raise ValueError(f"logical_reduce op must be and/or/xor, got {op!r}")
    if isinstance(mat, torch.Tensor):
        _check_words("mat", mat)
        rows = list(mat.contiguous().unbind(0))
    else:
        rows = list(mat)
    if not rows:
        raise ValueError("logical_reduce needs >= 1 row")
    if row_flags is None:
        flags = [None] * len(rows)
    elif isinstance(row_flags, torch.Tensor):
        flags = list(row_flags.contiguous().unbind(0))
    else:
        flags = list(row_flags)
    return _lr.fold(rows, flags, op=op)[0]


def diff_reduce(pos, pos_flags, neg, neg_flags) -> torch.Tensor:
    """AND(pos) & ~OR(neg) over sequences of 1-D int32 word rows with their
    flag rows (``None`` for a row whose blocks are all to be read): the
    executor's AND-NOT node, in one launch of the fused kernel per
    ``MAX_ROWS`` rows."""
    return _lr.fold(pos, pos_flags, neg, neg_flags, op="and")[0]
