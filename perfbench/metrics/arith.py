"""The benchmark's frozen metric arithmetic: the bytes that one fused
``logical_reduce`` call needs, the union of device intervals, and the
card's peak.  Copied here so that no change to the program moves the
yardstick.

``reduce_bytes`` is the rule of ``chip_smoke.reduce_bytes`` (the read rule
of ``csrc/logical_reduce.cu``), over NumPy flag rows: a DIRTY block of a
row is read unless an absorbing flag decides its flag column (CLEAN0 of a
pos row under ``and``, CLEAN1 under ``or``, CLEAN1 of a neg row), every
given flag row is read once, and the result row and its flag row are
written once.  A call that chains launches over more than 128 rows is
counted as one reduction: each input byte once, whatever the kernel reads
again.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

# the flag values and block width of ``repro_torch.kernels.word_logical``
DIRTY, CLEAN0, CLEAN1 = 0, 1, 2
FLAG_COLS = 1024
# one NVIDIA H100 SXM's HBM3, NVIDIA's data sheet
HBM_BYTES_PER_S = 3.35e12


def n_flag_cols(cols: int) -> int:
    return -(-cols // FLAG_COLS)


def reduce_bytes(flags: Sequence[Optional[np.ndarray]], n_pos: int,
                 op: str, cols: int) -> int:
    """Least bytes of ``fold_op(rows[:n_pos]) & ~OR(rows[n_pos:])`` over
    rows of ``cols`` words whose flag rows are ``flags`` (None: a row
    read whole)."""
    nfc = n_flag_cols(cols)
    f = np.stack([np.full(nfc, DIRTY, dtype=np.int64) if x is None
                  else np.asarray(x[:nfc], dtype=np.int64) for x in flags])
    pos, neg = f[:n_pos], f[n_pos:]
    if op == "and":
        pos_absorbs = (pos == CLEAN0).any(0)
    elif op == "or":
        pos_absorbs = (pos == CLEAN1).any(0)
    else:
        pos_absorbs = np.zeros(nfc, dtype=bool)
    zero = (neg == CLEAN1).any(0)
    if op == "and":
        zero |= pos_absorbs
    width = np.full(nfc, FLAG_COLS, dtype=np.int64)
    width[-1] = cols - (nfc - 1) * FLAG_COLS
    read_pos = ((pos == DIRTY) & ~(pos_absorbs | zero)).sum(0)
    read_neg = ((neg == DIRTY) & ~zero).sum(0)
    words_read = int(((read_pos + read_neg) * width).sum())
    n_flags = sum(nfc for x in flags if x is not None)
    return 4 * (words_read + n_flags + cols + nfc)


def merge(intervals: Iterable[Tuple[float, float]]) -> List[List[float]]:
    """Disjoint sorted intervals covering the same points."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_length(intervals: Iterable[Tuple[float, float]],
                 lo: float = -np.inf, hi: float = np.inf) -> float:
    """Length of the union of ``intervals`` clipped to [lo, hi]: streams
    that overlap count once."""
    return float(sum(max(0.0, min(e, hi) - max(s, lo))
                     for s, e in merge(intervals)))


def gaps(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in merge(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]
